"""On-device Hap container assembly and parse.

Builds a whole Hap frame -- headers, decode-instruction tables, chunked
Snappy payload -- as device tensors, and parses it back, with no host
round trip: every per-frame decision (per-chunk raw fallback, whole-frame
raw fallback, header checks) is a tensor op. Byte semantics are the
reference encoder's, so a frame built here is byte-identical to the host
serializer's around the same chunk streams.

The Snappy streams follow one of two device profiles, chosen by the
environment variable ``HAP_TPU_DEVICE_LZ`` at each call: the LZ profile
(``"1"``, the default; ``snappy/device_lz.py``, kernels A and C) or the
structured RLE profile (``"0"``; ``snappy/device.py``, kernels E and
D(ii)). Raw chunks go through kernel D and the stitch through kernel B
under both.

The parse side accepts the layout this encoder (and the reference encoder)
writes -- decode instructions, compressor table and size table at fixed
offsets, no offset table -- and flags anything else not-ok.
"""

from __future__ import annotations

import os

import torch

from hap_tpu_torch.constants import (
    CHUNK_COMPRESSOR_NONE,
    CHUNK_COMPRESSOR_SNAPPY,
    COMPRESSOR_COMPLEX,
    COMPRESSOR_NONE,
    SECTION_CHUNK_COMPRESSOR_TABLE,
    SECTION_CHUNK_SIZE_TABLE,
    SECTION_DECODE_INSTRUCTIONS,
    UINT24_MAX,
)
from hap_tpu_torch.kernels.layout import wrap_int32
from hap_tpu_torch.snappy.device import profile, snappy_encode_chunks
from hap_tpu_torch.snappy.device_lz import lz_bound, plan_lz
from hap_tpu_torch.snappy.lz_kernels import (
    decode_lz_streams_from_frame,
    emit_lz_streams,
)
from hap_tpu_torch.snappy.rle_kernels import decode_rle_streams_from_frame
from hap_tpu_torch.snappy.stream_kernels import (
    raw_chunks_from_frame,
    stitch_streams,
)

_I32 = torch.int32
_U8 = torch.uint8


def frame_layout(input_bytes: int, chunk_count: int, G: int):
    """Static layout of a (input_bytes, chunk_count) frame:
    (S, dil, top_hdr, bound, payload_off, fmax).

    ``bound`` covers both of the reference's stream profiles, so the frame
    shape does not depend on the profile; ``fmax`` carries a ``bound``
    guard tail so chunk reads never run past the buffer."""
    S = input_bytes // chunk_count
    dil = 5 * chunk_count + 8
    top_hdr = 8 if input_bytes > UINT24_MAX else 4
    if input_bytes + dil + 4 > UINT24_MAX:
        top_hdr = 8
    bound = max(profile(S, G).bound, lz_bound(S))
    payload_off = top_hdr + 4 + dil
    fmax = max(payload_off + chunk_count * bound, top_hdr + input_bytes)
    return S, dil, top_hdr, bound, payload_off, fmax + bound


def _u32le(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor (...) -> (..., 4) uint8 little-endian bytes."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(x >> s) & 0xFF for s in (0, 8, 16, 24)],
                       dim=-1).to(_U8)


def _header(length: torch.Tensor, section_type: int, hdr: int):
    """Section header bytes: 4-byte form (24-bit length) or 8-byte form
    (zero length bytes, type, then a 32-bit length)."""
    b = _u32le(length)
    t = torch.full((1,), section_type, dtype=_U8, device=length.device)
    if hdr == 4:
        return torch.cat([b[:3], t])
    return torch.cat([torch.zeros(3, dtype=_U8, device=length.device), t, b])


def _lz_enabled() -> bool:
    """The device Snappy profile switch, as the reference reads it: the LZ
    profile unless ``HAP_TPU_DEVICE_LZ`` is set to something other than
    ``"1"``, which selects the structured RLE profile. Read at every call
    (nothing is traced)."""
    return os.environ.get("HAP_TPU_DEVICE_LZ", "1") == "1"


def _encode_chunks(chunks: torch.Tensor, S: int, G: int, row_bytes: int):
    """(C, S) payload chunks -> ((C, B) uint8 streams, (C,) int32 stream
    lengths) under the active profile (B: that profile's stream bound)."""
    if not _lz_enabled():
        return snappy_encode_chunks(chunks, S, G)
    plan = plan_lz(chunks, S, G, row_bytes)
    return emit_lz_streams(chunks, plan, S), plan.comp_len


def _stitch_inputs(payload: torch.Tensor, comp: torch.Tensor,
                   comp_len: torch.Tensor, chunk_count: int, fmt_id: int,
                   G: int):
    """Container decisions around per-chunk streams -> (the arguments of
    ``stitch_streams``, () int32 frame length, (3,) int32 stats).

    A chunk is stored raw when its stream is not shorter than the chunk;
    the whole frame is stored raw when the complex section would not be
    shorter than the raw payload. Both decisions stay on the device. The
    stats are [Snappy chunks stored, payload bytes stored, whole-frame raw
    (0/1)]: 0 and ``input_bytes`` when the whole frame is raw."""
    dev = payload.device
    input_bytes = payload.shape[0]
    C = chunk_count
    S, dil, top_hdr, bound, payload_off, fmax = frame_layout(input_bytes, C, G)
    chunks = payload.reshape(C, S)
    is_comp = comp_len < S
    emit_len = torch.where(is_comp, comp_len, S)
    positions = torch.cumsum(emit_len, 0, dtype=_I32) - emit_len
    top_section_length = 4 + dil + positions[-1] + emit_len[-1]
    use_complex = top_section_length < input_bytes + top_hdr

    def const(v):
        return torch.full((), v, dtype=_I32, device=dev)

    comp_byte = torch.where(is_comp, CHUNK_COMPRESSOR_SNAPPY,
                            CHUNK_COMPRESSOR_NONE).to(_U8)
    header = torch.cat([
        _header(top_section_length, (COMPRESSOR_COMPLEX << 4) | fmt_id,
                top_hdr),
        _header(const(dil), SECTION_DECODE_INSTRUCTIONS, 4),
        _header(const(C), SECTION_CHUNK_COMPRESSOR_TABLE, 4),
        comp_byte,
        _header(const(4 * C), SECTION_CHUNK_SIZE_TABLE, 4),
        _u32le(emit_len).reshape(-1),
    ])
    header_raw = _header(const(input_bytes), (COMPRESSOR_NONE << 4) | fmt_id,
                         top_hdr)
    header[:top_hdr] = torch.where(use_complex, header[:top_hdr], header_raw)
    header_len = torch.where(use_complex, payload_off, top_hdr).to(_I32)
    raw_q = top_hdr + S * torch.arange(C, dtype=_I32, device=dev)
    q = torch.where(use_complex, payload_off + positions, raw_q)
    lengths = torch.where(use_complex, emit_len, S)
    src_comp = is_comp & use_complex
    frame_len = torch.where(use_complex, top_hdr + top_section_length,
                            top_hdr + input_bytes).to(_I32)
    stats = torch.stack([
        torch.where(use_complex, is_comp.sum(dtype=_I32), 0),
        torch.where(use_complex, top_section_length - 4 - dil, input_bytes),
        (~use_complex).to(_I32),
    ]).to(_I32)
    return ((header, header_len, comp, chunks, src_comp, q, lengths, fmax),
            frame_len, stats)


def _assemble_frame(payload, comp, comp_len, chunk_count, fmt_id, G):
    """Container assembly (kernel B) -> ((fmax,) uint8 frame, () int32
    frame length, (3,) int32 stats of ``_stitch_inputs``)."""
    args, frame_len, stats = _stitch_inputs(payload, comp, comp_len,
                                            chunk_count, fmt_id, G)
    return stitch_streams(*args), frame_len, stats


def encode_frame_device(payload: torch.Tensor, chunk_count: int, fmt_id: int,
                        G: int, row_bytes: int = 0):
    """(input_bytes,) uint8 block payload -> ((fmax,) uint8 frame, ()
    int32 frame length), on the payload's device.

    ``chunk_count`` must already be legal
    (``constants.legalize_chunk_count``). ``row_bytes`` (bytes per 4-pixel
    block row, G * W / 4) seeds the LZ planner's vertical-match
    candidates."""
    return encode_frame_device_stats(payload, chunk_count, fmt_id, G,
                                     row_bytes)[:2]


def encode_frame_device_stats(payload: torch.Tensor, chunk_count: int,
                              fmt_id: int, G: int, row_bytes: int = 0):
    """``encode_frame_device`` plus a (3,) int32 stats vector: [Snappy
    chunks stored, payload bytes stored (``input_bytes`` when the whole
    frame fell back to raw), whole-frame raw fallback (0/1)]. For a
    complex frame, ``chunk_count - stats[0]`` chunks were stored raw."""
    C = chunk_count
    S = payload.shape[0] // C
    comp, comp_len = _encode_chunks(payload.reshape(C, S), S, G, row_bytes)
    return _assemble_frame(payload, comp, comp_len, C, fmt_id, G)


def _le_field(frame: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """n-byte little-endian field at a static offset -> () int32 (n <= 3)
    or the 32-bit pattern as int32 (n == 4)."""
    b = frame[off: off + n].to(torch.int64)
    return wrap_int32(sum(b[i] << (8 * i) for i in range(n)))


def _decode_chunk_streams(frame, pos, csizes, is_comp, S: int, G: int):
    """Raw chunks through kernel D (which checks their true size-table
    entries), compressed chunks through the active profile's walk (kernel
    C, or D(ii) for the RLE profile) into the same rows."""
    out, ok = raw_chunks_from_frame(frame, pos, csizes, is_comp, S)
    if _lz_enabled():
        decode_lz_streams_from_frame(frame, pos, csizes, is_comp, S, out, ok)
    else:
        decode_rle_streams_from_frame(frame, pos, csizes, is_comp, S, G, out,
                                      ok)
    return out, ok


def _parse_tables(frame: torch.Tensor, input_bytes: int, chunk_count: int,
                  fmt_id: int, G: int):
    """Header and table parse -> (frame padded to fmax, pos, csizes,
    is_comp, S, [format ok, compressor known, top length ok, tables ok]).

    Raw-stored frames become C raw chunks of S bytes at stride S."""
    C = chunk_count
    S, dil, top_hdr, bound, payload_off, fmax = frame_layout(input_bytes, C, G)
    dev = frame.device
    if frame.shape[0] < fmax:
        frame = torch.cat([frame, torch.zeros(fmax - frame.shape[0],
                                              dtype=_U8, device=dev)])
    type_byte = frame[3].to(_I32)
    compressor = (type_byte >> 4) & 0xF
    fmt_ok = (type_byte & 0xF) == fmt_id
    is_raw = compressor == COMPRESSOR_NONE
    is_complex = compressor == COMPRESSOR_COMPLEX

    # table parse (garbage for raw frames, which ignore it)
    okc = frame[top_hdr + 3] == SECTION_DECODE_INSTRUCTIONS
    okc &= frame[top_hdr + 4 + 3] == SECTION_CHUNK_COMPRESSOR_TABLE
    okc &= frame[top_hdr + 8 + C + 3] == SECTION_CHUNK_SIZE_TABLE
    okc &= _le_field(frame, top_hdr, 3) == dil
    okc &= _le_field(frame, top_hdr + 4, 3) == C
    okc &= _le_field(frame, top_hdr + 8 + C, 3) == 4 * C
    comp_table = frame[top_hdr + 8: top_hdr + 8 + C]
    sb = frame[top_hdr + 12 + C: top_hdr + 12 + 5 * C].reshape(C, 4)
    sizes = wrap_int32(sum(sb[:, i].to(torch.int64) << (8 * i)
                           for i in range(4)))
    is_comp = comp_table == CHUNK_COMPRESSOR_SNAPPY
    okc &= torch.all(is_comp | (comp_table == CHUNK_COMPRESSOR_NONE))
    okc &= torch.all(sizes <= bound)
    sizes = torch.clamp(sizes, max=bound)
    positions = payload_off + torch.cumsum(sizes, 0, dtype=_I32) - sizes

    # top section length against the content (4- or 8-byte header form)
    if top_hdr == 8:
        declared = _le_field(frame, 4, 4)
        hdr_ok = torch.all(frame[:3] == 0)
    else:
        declared = _le_field(frame, 0, 3)
        hdr_ok = torch.ones((), dtype=torch.bool, device=dev)
    expected = torch.where(is_raw, input_bytes,
                           4 + dil + sizes.sum(dtype=_I32))
    top_len_ok = hdr_ok & (declared == expected)

    raw_positions = top_hdr + S * torch.arange(C, dtype=_I32, device=dev)
    pos = torch.where(is_raw, raw_positions, positions)
    csizes = torch.where(is_raw, S, sizes)
    checks = [fmt_ok, is_raw | is_complex, top_len_ok, is_raw | okc]
    return frame, pos, csizes, is_comp & ~is_raw, S, checks


def decode_frame_device(frame: torch.Tensor, input_bytes: int,
                        chunk_count: int, fmt_id: int, G: int,
                        out_words: bool = False, with_reasons: bool = False):
    """((F,) uint8 frame, static expectations) -> ((input_bytes,) uint8
    payload, () bool ok), on the frame's device.

    ``out_words`` returns the payload as (input_bytes // 4,) int32
    little-endian words (a view, no copy). ``with_reasons`` appends a (5,)
    int32 vector decomposing ok (1 = passed): [format nibble matches,
    compressor nibble known, top section length valid, decode-instruction
    tables valid, all chunk streams decoded]. ok=False (with best-effort
    output) flags foreign layouts and streams outside the device profile.
    """
    frame, pos, csizes, is_comp, S, checks = _parse_tables(
        frame, input_bytes, chunk_count, fmt_id, G)
    out, chunk_ok = _decode_chunk_streams(frame, pos, csizes, is_comp, S, G)
    checks.append(torch.all(chunk_ok))
    ok = checks[0]
    for c in checks[1:]:
        ok = ok & c
    out = out.reshape(-1)
    if out_words:
        out = out.view(_I32)
    if with_reasons:
        return out, ok, torch.stack(checks).to(_I32)
    return out, ok
