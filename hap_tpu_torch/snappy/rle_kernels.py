"""Kernels E and D(ii): the structured (RLE) profile's stream compaction and
its frame-direct unit walk.

Each wrapper launches its CUDA kernel (``csrc/rle_compact.cu``,
``csrc/rle_decode.cu``) for CUDA tensors and runs its plain version for CPU
tensors; there is no other fallback. ``RLE_COMPACT.launches`` and
``RLE_DECODE.launches`` count the kernel launches. The profile itself is
``snappy/device.py``.
"""

from __future__ import annotations

import ctypes

import torch

from hap_tpu_torch._build import CudaKernel, check_tensor, current_stream
from hap_tpu_torch.snappy.device import (
    _build_emissions,
    _lit_tag_bytes,
    profile,
)

_P, _I = ctypes.c_void_p, ctypes.c_int

RLE_COMPACT = CudaKernel(
    "rle_compact", "rle_compact.cu", "hap_rle_compact",
    # data, positions, sizes, out, C, S, G, out_width
    [_P, _P, _P, _P, _I, _I, _I, _I])

RLE_DECODE = CudaKernel(
    "rle_decode_from_frame", "rle_decode.cu", "hap_rle_decode",
    # frame, frame_len, pos, csizes, is_comp, out, ok, C, S, G
    [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _I, _I, _I])

# Launch-shape limits: E's grid has one row per chunk (CUDA caps grid.y at
# 65,535); D(ii) keeps three words of metadata per unit in shared memory.
_MAX_CHUNKS = 65535
_MAX_S = 1 << 24


def compact_streams_from_data(data: torch.Tensor, positions: torch.Tensor,
                              sizes: torch.Tensor, S: int, G: int,
                              out_width: int) -> torch.Tensor:
    """Compose every unit's emission from the payload and place it.

    data (C, S) uint8; positions, sizes (C, n_units) int32 -> (C,
    out_width) uint8: unit u of chunk c occupies ``positions[c, u] +
    [0, sizes[c, u])`` (clipped to the row; bytes past its composition
    are 0) and every other byte is 0. The size names the flavor: the
    literal size gives the literal (tag, then the unit's bytes), any other
    size the unit's run pattern (seeded for unit 0, with its first G bytes
    after the seed tag). Units must not overlap (positions are an exclusive cumsum of the
    sizes from ``positions[:, 0]``)."""
    p = profile(S, G)
    C = data.shape[0]
    if not data.is_cuda:
        return _compact_plain(data, positions, sizes, S, G, out_width)
    if C > _MAX_CHUNKS:
        raise ValueError(f"rle_compact takes at most {_MAX_CHUNKS} chunks")
    dev = data.device
    check_tensor(data, "data", torch.uint8, (C, S), dev)
    check_tensor(positions, "positions", torch.int32, (C, p.n_units), dev)
    check_tensor(sizes, "sizes", torch.int32, (C, p.n_units), dev)
    out = torch.empty((C, out_width), dtype=torch.uint8, device=dev)
    if C:
        RLE_COMPACT(data.data_ptr(), positions.data_ptr(), sizes.data_ptr(),
                    out.data_ptr(), C, S, G, out_width,
                    stream=current_stream(data))
    return out


def _compact_plain(data, positions, sizes, S, G, out_width):
    """Plain version of kernel E: the emissions table, then one scatter."""
    p = profile(S, G)
    C = data.shape[0]
    emit, _ = _build_emissions(data, S, G, sizes)
    within = torch.arange(p.emit_max)
    idx = positions.to(torch.int64)[:, :, None] + within
    keep = (within < sizes[:, :, None]) & (idx >= 0) & (idx < out_width)
    rows = torch.arange(C)[:, None, None].expand_as(idx)
    out = torch.zeros((C, out_width), dtype=torch.uint8)
    out[rows[keep], idx[keep]] = emit[keep]
    return out


def decode_rle_streams_from_frame(frame: torch.Tensor, pos: torch.Tensor,
                                  csizes: torch.Tensor, is_comp: torch.Tensor,
                                  S: int, G: int, out: torch.Tensor,
                                  ok: torch.Tensor) -> None:
    """Walk the compressed chunks' streams of this profile straight out of
    the frame.

    For every chunk with ``is_comp[c]``, the stream is the ``csizes[c]``
    bytes at ``frame[pos[c]:]``. It must start with varint(S); unit 0 must
    be seeded or a literal, every later full unit a copy or a literal, the
    tail a tail copy (after full units), seeded (when it is the whole
    chunk and longer than G) or a literal, each with every tag byte equal
    to its static pattern; and the units must end exactly at the stream's
    end. ``ok[c]`` says whether they did; row ``out[c]`` gets the decoded
    bytes, or zeros when not. Stream bytes past ``csizes[c]`` or outside
    the frame read as 0. Rows and flags of raw chunks are left untouched
    (kernel D writes them).

    frame (F,) uint8; pos, csizes (C,) int32; is_comp (C,) bool; out (C,
    S) uint8 and ok (C,) bool are written in place."""
    C = pos.shape[0]
    profile(S, G)
    if not frame.is_cuda:
        _decode_rle_plain(frame, pos, csizes, is_comp, S, G, out, ok)
        return
    if S > _MAX_S:
        raise ValueError(f"rle_decode takes chunks of at most {_MAX_S} B")
    dev = frame.device
    check_tensor(frame, "frame", torch.uint8, (frame.shape[0],), dev)
    check_tensor(pos, "pos", torch.int32, (C,), dev)
    check_tensor(csizes, "csizes", torch.int32, (C,), dev)
    check_tensor(is_comp, "is_comp", torch.bool, (C,), dev)
    check_tensor(out, "out", torch.uint8, (C, S), dev)
    check_tensor(ok, "ok", torch.bool, (C,), dev)
    if out.data_ptr() % 8:
        raise ValueError("out: must be 8-byte aligned")
    if C:
        RLE_DECODE(frame.data_ptr(), frame.shape[0], pos.data_ptr(),
                   csizes.data_ptr(), is_comp.data_ptr(), out.data_ptr(),
                   ok.data_ptr(), C, S, G, stream=current_stream(frame))


def _decode_rle_plain(frame, pos, csizes, is_comp, S, G, out, ok) -> None:
    """Plain version of kernel D(ii): the unit walk of every compressed
    chunk at once, one unit per step, as windowed gathers."""
    rows = torch.nonzero(is_comp).flatten()
    if not rows.numel():
        return
    p = profile(S, G)
    U, n_full, tail, P = p.U, p.n_full, p.tail, len(p.pre)
    F = frame.shape[0]
    off = pos[rows].to(torch.int64)
    clen = csizes[rows].to(torch.int64)
    avail = clen.clamp(0, p.bound)

    def window(cursor, width):
        rel = cursor[:, None] + torch.arange(width)
        at = off[:, None] + rel
        inside = (rel < avail[:, None]) & (at >= 0) & (at < F)
        return torch.where(inside, frame[at.clamp(0, max(F - 1, 0))], 0)

    def matches(win, start, pat):
        pat = torch.from_numpy(pat)
        return (win[:, start: start + len(pat)] == pat).all(dim=1)

    good = matches(window(torch.zeros_like(off), P), 0, p.pre)
    cursor = torch.full_like(off, P)
    prevg = torch.zeros((len(rows), G), dtype=torch.uint8)
    units = []
    for u in range(n_full):
        win = window(cursor, max(p.emit_max, p.seed_size))
        if u == 0:
            is_run = win[:, 0] == int(p.seed_pat[0])
            run_ok = matches(win, 1 + G, p.seed_pat[1:])
            prevg = torch.where(is_run[:, None], win[:, 1: 1 + G], prevg)
            adv = p.seed_size
        else:
            is_run = win[:, 0] == int(p.copy_pat[0])
            run_ok = matches(win, 0, p.copy_pat)
            adv = len(p.copy_pat)
        good &= torch.where(is_run, run_ok,
                            matches(win, 0, _lit_tag_bytes(U)))
        unit = torch.where(is_run[:, None], prevg.repeat(1, U // G),
                           win[:, p.lit_hdr: p.lit_hdr + U])
        prevg = unit[:, U - G:]
        cursor = cursor + torch.where(is_run, adv, p.emit_max)
        units.append(unit)
    if tail:
        win = window(cursor, max(p.tail_lit_size, p.tail_seed_size,
                                 len(p.tail_copy_pat)))
        is_run = torch.zeros_like(good)
        run_ok, adv = is_run, 0
        if n_full:
            is_run = win[:, 0] == int(p.tail_copy_pat[0])
            run_ok = matches(win, 0, p.tail_copy_pat)
            adv = len(p.tail_copy_pat)
        elif tail > G:
            is_run = win[:, 0] == int(p.tail_seed_pat[0])
            run_ok = matches(win, 1 + G, p.tail_seed_pat[1:])
            prevg = win[:, 1: 1 + G]
            adv = p.tail_seed_size
        h = len(p.tail_hdr)
        good &= torch.where(is_run, run_ok, matches(win, 0, p.tail_hdr))
        units.append(torch.where(is_run[:, None],
                                 prevg.repeat(1, -(-tail // G))[:, :tail],
                                 win[:, h: h + tail]))
        cursor = cursor + torch.where(is_run, adv, p.tail_lit_size)
    good &= cursor == clen
    dec = torch.cat(units, dim=1)
    out[rows] = torch.where(good[:, None], dec, 0).to(torch.uint8)
    ok[rows] = good
