"""Kernels A and C: LZ stream emission and frame-direct LZ stream decode.

Each wrapper launches its CUDA kernel (``csrc/lz_emit.cu``,
``csrc/lz_decode.cu``) for CUDA tensors and runs its plain version for CPU
tensors; there is no other fallback. ``LZ_EMIT.launches`` and
``LZ_DECODE.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hap_tpu_torch._build import CudaKernel, check_tensor, current_stream
from hap_tpu_torch.snappy.device_lz import (
    SEG_SLOTS,
    LzPlan,
    _varint,
    emit_reference,
    lz_bound,
)

_P, _I = ctypes.c_void_p, ctypes.c_int

LZ_EMIT = CudaKernel(
    "lz_emit", "lz_emit.cu", "hap_lz_emit",
    # data, tables_lit, tables_copy, counts, comp_len, out, C, S, nseg, bound
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I])

LZ_DECODE = CudaKernel(
    "lz_decode_from_frame", "lz_decode.cu", "hap_lz_decode",
    # frame, frame_len, pos, csizes, is_comp, out, ok, C, S
    [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _I, _I])


def emit_lz_streams(data: torch.Tensor, plan: LzPlan, S: int) -> torch.Tensor:
    """(C, S) uint8 payload chunks + their plan -> (C, lz_bound(S)) uint8
    Snappy streams: varint preamble, every piece at its recorded position,
    zeros past ``plan.comp_len``. Bit-identical to ``emit_reference``."""
    if not data.is_cuda:
        return emit_reference(data, plan, S)
    C = data.shape[0]
    nseg = plan.counts.shape[1]
    bound = lz_bound(S)
    dev = data.device
    check_tensor(data, "data", torch.uint8, (C, S), dev)
    for name, t, shape in (
            ("tables_lit", plan.tables_lit, (C, nseg * SEG_SLOTS, 2)),
            ("tables_copy", plan.tables_copy, (C, nseg * SEG_SLOTS, 2)),
            ("counts", plan.counts, (C, nseg, 2)),
            ("comp_len", plan.comp_len, (C,))):
        check_tensor(t, name, torch.int32, shape, dev)
    out = torch.empty((C, bound), dtype=torch.uint8, device=dev)
    LZ_EMIT(data.data_ptr(), plan.tables_lit.data_ptr(),
            plan.tables_copy.data_ptr(), plan.counts.data_ptr(),
            plan.comp_len.data_ptr(), out.data_ptr(), C, S, nseg, bound,
            stream=current_stream(data))
    return out


def decode_lz_streams_from_frame(frame: torch.Tensor, pos: torch.Tensor,
                                 csizes: torch.Tensor, is_comp: torch.Tensor,
                                 S: int, out: torch.Tensor,
                                 ok: torch.Tensor) -> None:
    """Decode the compressed chunks' streams straight out of the frame.

    For every chunk with ``is_comp[c]``: the stream of ``csizes[c]`` bytes
    at ``frame[pos[c]:]`` must start with varint(S) and hold only literals
    (1-3 byte tags) and copy-2 elements with offset >= 8 that produce
    exactly S bytes. Row ``out[c]`` gets the bytes and ``ok[c]`` whether
    the stream conformed; a stream that breaks a rule stops there, and the
    rest of its row is zeroed. Rows of raw chunks are left untouched.

    frame (F,) uint8; pos, csizes (C,) int32; is_comp (C,) bool; out
    (C, S) uint8 and ok (C,) bool are written in place."""
    C = pos.shape[0]
    if not frame.is_cuda:
        _decode_lz_plain(frame, pos, csizes, is_comp, S, out, ok)
        return
    dev = frame.device
    check_tensor(frame, "frame", torch.uint8, (frame.shape[0],), dev)
    check_tensor(pos, "pos", torch.int32, (C,), dev)
    check_tensor(csizes, "csizes", torch.int32, (C,), dev)
    check_tensor(is_comp, "is_comp", torch.bool, (C,), dev)
    check_tensor(out, "out", torch.uint8, (C, S), dev)
    check_tensor(ok, "ok", torch.bool, (C,), dev)
    LZ_DECODE(frame.data_ptr(), frame.shape[0], pos.data_ptr(),
              csizes.data_ptr(), is_comp.data_ptr(), out.data_ptr(),
              ok.data_ptr(), C, S, stream=current_stream(frame))


def _decode_lz_plain(frame, pos, csizes, is_comp, S, out, ok) -> None:
    """Plain version of kernel C: a host walk per compressed chunk."""
    f = frame.numpy().tobytes()
    pre = _varint(S).tobytes()
    for c in np.flatnonzero(is_comp.numpy()):
        row, good = _walk_chunk(f, int(pos[c]), int(csizes[c]), S, pre)
        out[c] = torch.from_numpy(row)
        ok[c] = good


def _walk_chunk(f: bytes, off: int, clen: int, S: int, pre: bytes):
    """One chunk's stream walk -> ((S,) uint8 row, ok). Bytes outside the
    frame read as 0."""
    F = len(f)

    def rd(i):
        return f[i] if 0 <= i < F else 0

    o = bytearray(S)
    end = off + clen
    outp = 0
    cur = off + len(pre)
    good = all(rd(off + i) == b for i, b in enumerate(pre))
    while good and outp < S:
        if cur >= end:
            good = False
            break
        tag, b1, b2 = rd(cur), rd(cur + 1), rd(cur + 2)
        kind, t6 = tag & 3, tag >> 2
        if kind == 0:  # literal, 1-3 byte tag
            if t6 < 60:
                tl, n = 1, t6 + 1
            elif t6 == 60:
                tl, n = 2, b1 + 1
            elif t6 == 61:
                tl, n = 3, (b1 | (b2 << 8)) + 1
            else:
                good = False
                break
            if cur + tl + n > end or outp + n > S:
                good = False
                break
            src = cur + tl
            lo, hi = max(src, 0), min(src + n, F)
            if lo < hi:
                o[outp + lo - src: outp + hi - src] = f[lo:hi]
            cur += tl + n
            outp += n
        elif kind == 2:  # copy-2
            d, n = b1 | (b2 << 8), t6 + 1
            if cur + 3 > end or d < 8 or d > outp or outp + n > S:
                good = False
                break
            period = o[outp - d: outp]
            o[outp: outp + n] = (period * (n // d + 1))[:n]
            cur += 3
            outp += n
        else:  # copy-1 / copy-4 are outside the device profile
            good = False
            break
    if good and cur != end:
        good = False
    if not good:
        o[outp:] = bytes(S - outp)
    return np.frombuffer(o, np.uint8), good
