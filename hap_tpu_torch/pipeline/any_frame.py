"""Decode of any legal Hap Q frame on the device (foreign frames).

The main path (``device_pipeline.decode_pipeline``) accepts only the fixed
layout the port's encoder writes, with LZ-profile Snappy streams. This
module decodes what other encoders write: offset tables, either header
form, any section order, chunks stored in any order, uneven chunk sizes,
mixed raw/Snappy chunks, and arbitrary google-snappy streams. Only Hap Q
(one YCoCg_DXT5 texture) is ported; other formats raise
``NotImplementedError``.

Two byte-plane routes (``snappy=``; default env HAP_TPU_FOREIGN_SNAPPY,
else "table"):

* "table": the host parses each Snappy stream into a table of pieces
  (``snappy/optable.py``) and kernel G (``exec_kernels``) replays them;
  ``ForeignGopSession`` stages frames on the host and decodes a whole GOP
  with one kernel-G launch over all N x C chunks.
* "kernel": kernel F (``general_kernels``) parses, validates and decodes
  the streams on the device, for frames whose bytes are only there.

Either way, the texture decode is ``device_pipeline.decode_blocks``.
Entry points default to ``device="cuda"`` and raise without CUDA unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from hap_tpu_torch.constants import (
    CHUNK_COMPRESSOR_SNAPPY,
    HAP_Q_BLOCK_BYTES,
    HapError,
    dxt_payload_bytes,
)
from hap_tpu_torch.container.parse import parse_frame
from hap_tpu_torch.device import resolve_device
from hap_tpu_torch.kernels.bc1 import bc1_decode_planes
from hap_tpu_torch.kernels.bc4 import bc4_decode_planes
from hap_tpu_torch.kernels.layout import (
    block_planes_to_image,
    deinterleave_words,
    payload_to_words,
)
from hap_tpu_torch.kernels.ycocg import cocgs_y_to_rgb_planes
from hap_tpu_torch.pipeline.codecs import HapCodec, codec_for_plan
from hap_tpu_torch.snappy.exec_kernels import execute_op_tables
from hap_tpu_torch.snappy.general_kernels import decode_any_streams
from hap_tpu_torch.snappy.optable import PackedTables, pack_tables

_ROUTES = ("table", "kernel")


def _ceil(n: int, g: int) -> int:
    return -(-n // g) * g


def _default_snappy_route() -> str:
    return os.environ.get("HAP_TPU_FOREIGN_SNAPPY", "table")


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``dev``; to a GPU through a pinned buffer
    with a non-blocking copy (PyTorch's pinned-memory cache keeps the
    buffer until the copy has run)."""
    if dev.type != "cuda":
        return torch.from_numpy(np.array(a))  # a writable copy
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    pinned = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = a
    return pinned.to(dev, non_blocking=True)


@dataclass
class _ChunkTables:
    """One texture's chunk tables from the host parse (numpy)."""

    comp_off: np.ndarray  # (C,) int64 stream offsets in the frame
    comp_len: np.ndarray  # (C,) int64 stored sizes
    out_off: np.ndarray  # (C,) int64 offsets in the decoded texture
    out_len: np.ndarray  # (C,) int64 decoded sizes
    is_comp: np.ndarray  # (C,) bool, Snappy chunk (else raw)
    S_max: int
    total: int

    @classmethod
    def of(cls, tex) -> "_ChunkTables":
        usizes = np.asarray(tex.chunk_uncompressed_sizes, np.int64)
        return cls(np.asarray(tex.chunk_compressed_offsets, np.int64),
                   np.asarray(tex.chunk_compressed_sizes, np.int64),
                   np.asarray(tex.chunk_uncompressed_offsets, np.int64),
                   usizes,
                   np.asarray(tex.chunk_compressors)
                   == CHUNK_COMPRESSOR_SNAPPY,
                   max(int(usizes.max(initial=0)), 1),
                   int(tex.decoded_bytes))

    def streams(self, frame_np: np.ndarray):
        """(Snappy streams, expected sizes); raw chunks get an empty stream
        and size 0 (their table is empty; they bypass the executor)."""
        streams, exp = [], []
        for i in range(len(self.comp_len)):
            if self.is_comp[i]:
                o = int(self.comp_off[i])
                streams.append(frame_np[o: o + int(self.comp_len[i])]
                               .tobytes())
                exp.append(int(self.out_len[i]))
            else:
                streams.append(b"")
                exp.append(0)
        return streams, exp

    def uniform(self) -> bool:
        """hap.c's layout: every chunk S_max bytes, in order."""
        return bool((self.out_len == self.S_max).all() and (
            self.out_off == self.S_max * np.arange(len(self.out_len))).all())


def _i32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=dev)


def _stitch_payload(frames: torch.Tensor, dec: torch.Tensor,
                    comp_off: torch.Tensor, out_off: torch.Tensor,
                    is_comp: torch.Tensor, S_max: int,
                    total: int) -> torch.Tensor:
    """Place decoded and raw chunk rows at their decoded offsets, for N
    frames at once -> (N, total) uint8.

    frames (N, F) uint8 (bytes past a frame read as 0); dec (N, C, S_max)
    decoded Snappy rows; comp_off, out_off (N, C) int; is_comp (N, C).
    The reference writes each chunk's whole S_max-wide row in increasing
    out_off order, so a row's tail is healed by the next chunk's write.
    One gather gives the same bytes: output byte p comes from the last
    chunk in that order with out_off <= p, if p lies within its row (ties
    keep chunk order, as a stable sort does), else it is 0."""
    N, F = frames.shape
    dev = frames.device
    oo, order = torch.sort(out_off.to(torch.int64), dim=1, stable=True)
    p = torch.arange(total, device=dev).expand(N, total).contiguous()
    k = torch.searchsorted(oo, p, right=True) - 1
    c = torch.gather(order, 1, k.clamp(min=0))
    o = p - torch.gather(oo, 1, k.clamp(min=0))
    inside = (k >= 0) & (o < S_max)
    oc = o.clamp(0, S_max - 1)
    rows = torch.arange(N, device=dev)[:, None]
    from_dec = dec[rows, c, oc]
    fi = torch.gather(comp_off.to(torch.int64), 1, c) + oc
    from_raw = torch.where((fi >= 0) & (fi < F),
                           frames[rows, fi.clamp(0, max(F - 1, 0))], 0)
    byte = torch.where(torch.gather(is_comp, 1, c), from_dec, from_raw)
    return torch.where(inside, byte, 0).to(torch.uint8)


def _texture_payload_device(frame_dev: torch.Tensor, t: _ChunkTables):
    """"kernel" route: device frame bytes + host chunk tables -> ((total,)
    payload, () ok). One gather cuts the (C, B) stream rows out of the
    frame; B is the longest Snappy stream (the reference buckets it only to
    bound its jit recompiles, which PyTorch does not have)."""
    dev = frame_dev.device
    F = frame_dev.shape[0]
    B = max(int(t.comp_len[t.is_comp].max(initial=0)), 1)
    idx = (torch.as_tensor(t.comp_off, device=dev)[:, None]
           + torch.arange(B, device=dev))
    comp = torch.where(idx < F, frame_dev[idx.clamp(0, max(F - 1, 0))], 0
                       ).to(torch.uint8)
    is_comp = torch.as_tensor(t.is_comp, device=dev)
    klen = _i32(np.where(t.is_comp, t.comp_len, 0), dev)
    ulen = _i32(np.where(t.is_comp, t.out_len, 0), dev)
    dec, ok = decode_any_streams(comp, klen, ulen, t.S_max)
    payload = _stitch_payload(
        frame_dev[None], dec[None], torch.as_tensor(t.comp_off[None],
                                                    device=dev),
        torch.as_tensor(t.out_off[None], device=dev), is_comp[None],
        t.S_max, t.total)[0]
    return payload, (ok | ~is_comp).all()


def _texture_payload_device_tables(frame_np: np.ndarray,
                                   frame_dev: torch.Tensor, t: _ChunkTables):
    """"table" route: the host compiles each Snappy stream into a piece
    table, kernel G replays them, then the stitch -> (payload, ok)."""
    dev = frame_dev.device
    streams, exp = t.streams(frame_np)
    p = pack_tables(streams, exp, S_max=t.S_max)
    ok_host = bool((p.ok.numpy() | ~t.is_comp).all())
    dec = execute_op_tables(p.ops.to(dev), p.n_ops.to(dev), p.lit.to(dev),
                            p.out_len.to(dev), t.S_max)
    payload = _stitch_payload(
        frame_dev[None], dec[None],
        torch.as_tensor(t.comp_off[None], device=dev),
        torch.as_tensor(t.out_off[None], device=dev),
        torch.as_tensor(t.is_comp[None], device=dev), t.S_max, t.total)[0]
    return payload, torch.tensor(ok_host, device=dev)


def _check_payload(total: int, height: int, width: int) -> None:
    need = dxt_payload_bytes(width, height, HAP_Q_BLOCK_BYTES)
    if total != need:
        raise HapError(f"the texture decodes to {total} bytes; a {width}x"
                       f"{height} Hap Q frame holds {need}")


def _decode_words(words: torch.Tensor, n: int, height: int, width: int
                  ) -> torch.Tensor:
    """(n, N*4) int32 payload words of n frames -> (n, H, W, 3) uint8: the
    texture decode of ``device_pipeline.decode_blocks``, over all frames'
    blocks at once."""
    y0, y1, c0, c1 = deinterleave_words(words.reshape(-1), 4)
    cocgs, _ = bc1_decode_planes(c0, c1, dxt1_punchthrough=False)
    rgb = cocgs_y_to_rgb_planes(cocgs, bc4_decode_planes(y0, y1))
    nb = rgb.shape[2] // n
    return torch.stack([
        block_planes_to_image(rgb[:, :, k * nb:(k + 1) * nb], height, width)
        for k in range(n)])


def decode_frame_any_device(frame, height: int, width: int,
                            frame_dev: Optional[torch.Tensor] = None,
                            snappy: Optional[str] = None, device="cuda"):
    """Decode any legal Hap Q frame on ``device`` -> ((H, W, 3) uint8
    pixels, () bool ok), both device tensors, without synchronising.

    ``frame_dev``: the same bytes as a uint8 tensor already on the device
    (skips the upload; its device wins). ``snappy``: "table" (host op-table
    compile + kernel G) or "kernel" (kernel F). ok is False when a Snappy
    stream is malformed; the pixels are then garbage."""
    dev = frame_dev.device if frame_dev is not None else resolve_device(
        device)
    frame = bytes(frame)
    plan = parse_frame(frame)
    codec_for_plan(plan)  # raises for a codec that is not ported
    if snappy is None:
        snappy = _default_snappy_route()
    if snappy not in _ROUTES:
        raise ValueError(f"snappy={snappy!r}: expected one of {_ROUTES}")
    frame_np = np.frombuffer(frame, np.uint8)
    if frame_dev is None:
        frame_dev = _upload(frame_np, dev)
    t = _ChunkTables.of(plan.textures[0])
    _check_payload(t.total, height, width)
    if snappy == "table":
        payload, ok = _texture_payload_device_tables(frame_np, frame_dev, t)
    else:
        payload, ok = _texture_payload_device(frame_dev, t)
    return _decode_words(payload_to_words(payload)[None], 1, height,
                         width)[0], ok


@dataclass
class _StagedTexture:
    """One texture's staged decode inputs (device tensors)."""

    ops_packed: torch.Tensor  # (P, 2) int32: all chunks' pieces, padded
    n_ops: torch.Tensor  # (C,) int32
    lit_packed: torch.Tensor  # (Q,) uint8: all chunks' literals, padded
    out_len: torch.Tensor  # (C,) int32
    comp_off: torch.Tensor  # (C,) int32
    out_off: torch.Tensor  # (C,) int32
    is_comp: torch.Tensor  # (C,) bool
    S_max: int
    total: int
    raw_rows: Optional[Tuple[torch.Tensor, torch.Tensor]]  # (R, S_max), (C,)
    ops_off: torch.Tensor  # (C,) int32 first piece of each chunk
    lit_off: torch.Tensor  # (C,) int32 first literal byte of each chunk
    nops_maxlen: int
    lit_maxlen: int


@dataclass
class StagedForeignFrame:
    """Host-compiled, device-staged decode inputs of one foreign frame,
    made by ``ForeignGopSession.stage`` (uploads are asynchronous, so
    staging frame k+1 overlaps decoding frame k). Frames with equal
    ``profile`` can share one ``decode_gop`` call."""

    frame_len: int
    spec: HapCodec
    profile: tuple
    ok_host: bool
    frame_dev: Optional[torch.Tensor]  # (F,) uint8; None when uniform
    per_texture: List[_StagedTexture]
    stage_ms: dict = field(default_factory=dict)  # host ms: parse, compile,
    # upload


class ForeignGopSession:
    """Batched serving of foreign Hap Q frames.

    ``stage``: the host parses the container, compiles op tables
    (``snappy/optable.py``) and starts the uploads. ``decode_gop``: decodes
    N staged frames with one kernel-G launch over all N x C chunk streams,
    one payload fold, and one texture decode over all frames.

    Frames in one ``decode_gop`` call must share codec, dimensions and
    chunk profile (a stream's GOP does); ``stage`` records the profile so
    callers can group mixed streams. Nothing is compiled per profile here
    (PyTorch runs eagerly); the profile count and ``max_profiles`` are kept
    as the reference keeps them, for ``compile_stats``.

    ``promote`` picks the literal-promotion policy of the op-table
    compiler: "pieces" promotes at the piece-optimal threshold
    (``optable.default_promote_max``); "auto" compiles both variants and
    keeps, per texture, the one minimising staged_bytes *
    HAP_TPU_STAGE_NS_PER_BYTE (default 26) + pieces *
    HAP_TPU_EXEC_NS_PER_PIECE (default 80); an int pins promote_max.
    """

    def __init__(self, height: int, width: int, max_profiles: int = 16,
                 promote="pieces", device="cuda"):
        if not (promote in ("pieces", "auto") or isinstance(promote, int)):
            raise ValueError(f"promote={promote!r}: expected 'pieces', "
                             "'auto' or an int")
        self.height = height
        self.width = width
        self.max_profiles = max_profiles
        self.promote = promote
        self.device = resolve_device(device)
        self._profiles_seen = set()
        self.cache_evictions = 0

    def _pack(self, streams, exp, S_max) -> PackedTables:
        if self.promote == "pieces":
            return pack_tables(streams, exp, S_max=S_max)
        if isinstance(self.promote, int):
            return pack_tables(streams, exp, S_max=S_max,
                               promote_max=self.promote)
        p0 = pack_tables(streams, exp, S_max=S_max, promote_max=0)
        p1 = pack_tables(streams, exp, S_max=S_max)
        ns_b = float(os.environ.get("HAP_TPU_STAGE_NS_PER_BYTE", "26"))
        ns_p = float(os.environ.get("HAP_TPU_EXEC_NS_PER_PIECE", "80"))

        def cost(p):
            staged = p.ops.nbytes + p.lit.nbytes
            return staged * ns_b + float(p.n_ops.sum()) * ns_p

        return p0 if cost(p0) <= cost(p1) else p1

    def stage(self, frame) -> StagedForeignFrame:
        dev = self.device
        t0 = time.perf_counter()
        frame = bytes(frame)
        plan = parse_frame(frame)
        spec = codec_for_plan(plan)
        frame_np = np.frombuffer(frame, np.uint8)
        tables = [_ChunkTables.of(tex) for tex in plan.textures]
        ms = {"parse": (time.perf_counter() - t0) * 1e3, "compile": 0.0,
              "upload": 0.0}

        # hap.c's uniform layout needs no stitch and no frame bytes on the
        # device, only dense per-chunk rows; other layouts upload the frame.
        all_uniform = all(t.uniform() for t in tables)
        frame_dev = None
        fpad = 0
        if not all_uniform:
            fpad = _ceil(max(len(frame), 1), 1 << 20)  # profile key only
            t0 = time.perf_counter()
            frame_dev = _upload(frame_np, dev)
            ms["upload"] += (time.perf_counter() - t0) * 1e3

        per_texture = []
        prof = [spec.name, fpad, all_uniform]
        ok_host = True
        for t in tables:
            t0 = time.perf_counter()
            p = self._pack(*t.streams(frame_np), t.S_max)
            ok_host &= bool((p.ok.numpy() | ~t.is_comp).all())
            # packed staging: each chunk's true pieces and literals back to
            # back, with per-chunk offsets (decode_gop rebuilds the dense
            # layout on the device); padded as the reference pads them
            no = p.n_ops.numpy().astype(np.int64)
            nl = p.n_lit.numpy().astype(np.int64)
            ops_off = np.concatenate(([0], np.cumsum(no)[:-1]))
            lit_off = np.concatenate(([0], np.cumsum(nl)[:-1]))
            j_ops = np.arange(p.ops.shape[1])[None, :] < no[:, None]
            j_lit = np.arange(p.lit.shape[1])[None, :] < nl[:, None]
            ops_packed = np.zeros((_ceil(max(int(no.sum()), 1), 4096), 2),
                                  np.int32)
            ops_packed[:int(no.sum())] = p.ops.numpy()[j_ops]
            lit_packed = np.zeros(_ceil(max(int(nl.sum()), 1), 65536),
                                  np.uint8)
            lit_packed[:int(nl.sum())] = p.lit.numpy()[j_lit]
            # uniform layouts with raw chunks: only the raw chunks' rows are
            # staged, with a (C,) row map
            raw = None
            if all_uniform and not t.is_comp.all():
                ridx = np.nonzero(~t.is_comp)[0]
                rp = np.zeros((_ceil(len(ridx), 4), t.S_max), np.uint8)
                rmap = np.zeros(len(t.is_comp), np.int32)
                for k, i in enumerate(ridx):
                    o, n = int(t.comp_off[i]), int(t.comp_len[i])
                    rp[k, :n] = frame_np[o: o + n]
                    rmap[i] = k
                raw = (rp, rmap)
            t1 = time.perf_counter()
            ms["compile"] += (t1 - t0) * 1e3
            per_texture.append(_StagedTexture(
                ops_packed=_upload(ops_packed, dev),
                n_ops=_upload(p.n_ops.numpy(), dev),
                lit_packed=_upload(lit_packed, dev),
                out_len=_upload(p.out_len.numpy(), dev),
                comp_off=_upload(t.comp_off.astype(np.int32), dev),
                out_off=_upload(t.out_off.astype(np.int32), dev),
                is_comp=_upload(t.is_comp, dev), S_max=t.S_max,
                total=t.total,
                raw_rows=(None if raw is None else
                          (_upload(raw[0], dev), _upload(raw[1], dev))),
                ops_off=_upload(ops_off.astype(np.int32), dev),
                lit_off=_upload(lit_off.astype(np.int32), dev),
                nops_maxlen=int(no.max(initial=1)),
                lit_maxlen=int(nl.max(initial=1))))
            ms["upload"] += (time.perf_counter() - t1) * 1e3
            prof.extend([len(t.is_comp), t.S_max, raw is not None, t.total])
        return StagedForeignFrame(
            frame_len=len(frame), spec=spec, profile=tuple(prof),
            ok_host=ok_host, frame_dev=frame_dev, per_texture=per_texture,
            stage_ms=ms)

    def hbm_bytes_per_frame(self, staged_frame, nmax_by_tex=None,
                            lmax_by_tex=None) -> int:
        """Estimated device residency of one staged frame in a GOP decode:
        decoded rows + payload + the staged packed planes + the dense
        (C, nmax) executor layout + output pixels, with the reference's
        formula. ``nmax_by_tex``/``lmax_by_tex`` replace the frame's own
        ops/literal maxima with the GOP-wide widths."""
        per_frame = 0
        for ti, t in enumerate(staged_frame.per_texture):
            C = t.n_ops.shape[0]
            nops_max = (nmax_by_tex[ti] if nmax_by_tex is not None
                        else t.nops_maxlen)
            lit_max = (lmax_by_tex[ti] if lmax_by_tex is not None
                       else t.lit_maxlen)
            per_frame += (C * t.S_max * 4 + t.total
                          + t.ops_packed.nbytes + t.lit_packed.nbytes
                          + C * nops_max * 8 + C * lit_max)
        per_frame += 4 * self.height * self.width * 4  # pixels + folds
        return per_frame

    def decode_gop(self, staged: list):
        """[StagedForeignFrame] -> ((N, H, W, 3) uint8 pixels, (N,) bool
        ok) on the session's device, without synchronising."""
        if not staged:
            raise ValueError("empty GOP")
        prof = staged[0].profile
        if any(s.profile != prof for s in staged):
            raise ValueError("decode_gop requires a uniform frame profile; "
                             "group by .profile for mixed streams")
        self._profiles_seen.add(prof)
        if len(self._profiles_seen) > self.max_profiles:
            self._profiles_seen = {prof}
            self.cache_evictions += 1
        # device-memory guard, the reference's estimate and 12 GiB limit:
        # every frame is padded to the GOP-wide (bucketed) ops/lit maxima
        nmax_by_tex = [_ceil(max(s.per_texture[ti].nops_maxlen
                                 for s in staged), 512)
                       for ti in range(len(staged[0].per_texture))]
        lmax_by_tex = [_ceil(max(s.per_texture[ti].lit_maxlen
                                 for s in staged), 8192)
                       for ti in range(len(staged[0].per_texture))]
        per_frame = max(self.hbm_bytes_per_frame(s, nmax_by_tex, lmax_by_tex)
                        for s in staged)
        est = per_frame * len(staged)
        if est > 12 * 2**30:
            raise ValueError(
                f"GOP of {len(staged)} frames needs ~{est/2**30:.1f} GiB "
                f"of device memory in one decode; split the GOP (~"
                f"{max(1, int(12 * 2**30 // per_frame))} frames fit)")
        ts = [s.per_texture[0] for s in staged]  # Hap Q: one texture
        payload = _gop_payload(
            None if staged[0].frame_dev is None
            else [s.frame_dev for s in staged], ts)
        n = len(staged)
        words = (payload if payload.dtype == torch.int32
                 else payload_to_words(payload.reshape(-1)).reshape(n, -1))
        _check_payload(ts[0].total, self.height, self.width)
        pixels = _decode_words(words, n, self.height, self.width)
        ok = torch.tensor([s.ok_host for s in staged], device=self.device)
        return pixels, ok

    def compile_stats(self) -> dict:
        """Profile counts of the serving loop. Nothing is compiled per
        profile in the port, so ``compiled_programs`` is always 0."""
        return {
            "profiles_seen": len(self._profiles_seen),
            "compiled_programs": 0,
            "cache_evictions": self.cache_evictions,
            "max_profiles": self.max_profiles,
        }


def _rebuild(packed, offs, widths, starts):
    """Packed per-frame planes + per-chunk offsets -> one dense (N*C,
    width[, 2]) executor layout, with one gather."""
    flat = torch.cat(packed)
    base = torch.cat([o.to(torch.int64) + s for o, s in zip(offs, starts)])
    idx = base[:, None] + torch.arange(widths, device=flat.device)
    return flat[idx.clamp(max=flat.shape[0] - 1)]


def _gop_payload(frames, ts: List[_StagedTexture]) -> torch.Tensor:
    """All N frames' chunk streams through ONE kernel-G launch, then the
    payload fold -> (N, total) uint8, or (N, total/4) int32 words on
    uniform layouts: there the decoded rows are the payload (raw chunks'
    rows are gathered from the staged raw rows)."""
    t0 = ts[0]
    N, C, S_max, total = len(ts), t0.n_ops.shape[0], t0.S_max, t0.total
    dev = t0.n_ops.device
    nmax = max(t.nops_maxlen for t in ts)
    lmax = max(t.lit_maxlen for t in ts)
    ops_starts = np.cumsum([0] + [t.ops_packed.shape[0] for t in ts[:-1]])
    lit_starts = np.cumsum([0] + [t.lit_packed.shape[0] for t in ts[:-1]])
    ops = _rebuild([t.ops_packed for t in ts], [t.ops_off for t in ts], nmax,
                   ops_starts.tolist())
    lit = _rebuild([t.lit_packed for t in ts], [t.lit_off for t in ts], lmax,
                   lit_starts.tolist())
    n_ops = torch.cat([t.n_ops for t in ts])
    out_len = torch.cat([t.out_len for t in ts])
    is_comp = torch.stack([t.is_comp for t in ts])
    frames_idx = torch.arange(N, device=dev)[:, None]
    words = frames is None and S_max % 4 == 0 and total % 4 == 0
    dec = execute_op_tables(ops, n_ops, lit, out_len, S_max,
                            out_words=words).reshape(N, C, -1)
    if frames is None:
        if t0.raw_rows is not None:
            R = max(t.raw_rows[0].shape[0] for t in ts)
            raw = torch.stack([torch.nn.functional.pad(
                t.raw_rows[0], (0, 0, 0, R - t.raw_rows[0].shape[0]))
                for t in ts])  # (N, R, S_max)
            if words:
                raw = raw.view(torch.int32)
            rows = raw[frames_idx, torch.stack([t.raw_rows[1] for t in ts]
                                               ).to(torch.int64)]
            dec = torch.where(is_comp[:, :, None], dec, rows)
        return dec.reshape(N, -1)[:, : total // 4 if words else total]
    F = max(f.shape[0] for f in frames)
    fstack = torch.stack([torch.nn.functional.pad(f, (0, F - f.shape[0]))
                          for f in frames])
    return _stitch_payload(fstack, dec,
                           torch.stack([t.comp_off for t in ts]),
                           torch.stack([t.out_off for t in ts]), is_comp,
                           S_max, total)


def decode_frames_any_device(frames, height: int, width: int,
                             device="cuda"):
    """Stage and decode one GOP of foreign frames of one profile."""
    sess = ForeignGopSession(height, width, device=device)
    return sess.decode_gop([sess.stage(f) for f in frames])


def decode_frame_any(frame, height: int, width: int, via: str = "device",
                     snappy: Optional[str] = None, device="cuda"
                     ) -> Tuple[np.ndarray, bool]:
    """Decode any legal Hap Q frame to ((H, W, 3) host pixels, ok).

    Only via="device" is ported (``decode_frame_any_device``; ``snappy``
    selects the route). ok is False only for streams flagged malformed."""
    if via != "device":
        raise NotImplementedError(f"via={via!r}: only 'device' is ported")
    img, ok = decode_frame_any_device(frame, height, width, snappy=snappy,
                                      device=device)
    return img.cpu().numpy(), bool(ok)
