"""Kernel F: general Snappy decode of the foreign-frame "kernel" route.

``decode_any_streams`` launches ``csrc/general_decode.cu`` for CUDA
tensors and runs its plain version (a per-chunk walk with the same rules)
for CPU tensors; there is no other fallback. ``GENERAL_DECODE.launches``
counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hap_tpu_torch._build import CudaKernel, check_tensor, current_stream

_P, _I = ctypes.c_void_p, ctypes.c_int

GENERAL_DECODE = CudaKernel(
    "general_decode", "general_decode.cu", "hap_general_decode",
    # comp, B, comp_len, out_len, out, ok, S_max, C
    [_P, _I, _P, _P, _P, _P, _I, _I])


def decode_any_streams(comp: torch.Tensor, comp_len: torch.Tensor,
                       out_len: torch.Tensor, S_max: int):
    """Decode C arbitrary Snappy streams -> ((C, S_max) uint8, (C,) bool).

    comp (C, B) uint8 stream rows (bytes past B read as 0); comp_len,
    out_len (C,) int32. ok[c] is False for a malformed stream (bad or
    mismatched preamble, offset 0 or past the bytes produced, an element
    overrunning the stream or out_len, trailing bytes); its row holds the
    bytes decoded before the first broken rule, then zeros. Bytes
    [out_len, S_max) of every row are zero."""
    C, B = comp.shape
    if not comp.is_cuda:
        return _decode_plain(comp, comp_len, out_len, S_max)
    dev = comp.device
    check_tensor(comp, "comp", torch.uint8, (C, B), dev)
    check_tensor(comp_len, "comp_len", torch.int32, (C,), dev)
    check_tensor(out_len, "out_len", torch.int32, (C,), dev)
    out = torch.empty((C, S_max), dtype=torch.uint8, device=dev)
    ok = torch.empty(C, dtype=torch.bool, device=dev)
    GENERAL_DECODE(comp.data_ptr(), B, comp_len.data_ptr(),
                   out_len.data_ptr(), out.data_ptr(), ok.data_ptr(), S_max,
                   C, stream=current_stream(comp))
    return out, ok


def _decode_row(row: bytes, clen: int, ulen: int, S_max: int, out):
    """Walk one stream into ``out`` (a zeroed bytearray of S_max); the
    kernel's rules, element by element. Returns ok."""
    def rd(i):
        return row[i] if 0 <= i < len(row) else 0

    # varint preamble: at most 5 bytes, the 5th below 8
    b = [rd(i) for i in range(5)]
    val, hdr, inc, good = b[0] & 127, 1, b[0] >= 128, True
    for i in range(1, 5):
        if i == 4:
            good = good and (not inc or b[4] < 8)
        if inc:
            val += (b[i] & 127) << (7 * i)
            hdr += 1
        inc = inc and b[i] >= 128
    good = good and not inc and val == ulen and hdr <= clen and ulen <= S_max
    cur, op = hdr, 0
    while good and cur < clen:
        tag, b1, b2, b3, b4 = (rd(cur + i) for i in range(5))
        kind, len6 = tag & 3, tag >> 2
        if kind == 0:
            ehdr = 1 if len6 < 60 else len6 - 58
            ext = (b1 + (b2 << 8 if len6 >= 61 else 0)
                   + (b3 << 16 if len6 >= 62 else 0)
                   + (b4 << 24 if len6 >= 63 else 0))
            elen = len6 + 1 if len6 < 60 else ext + 1
            in_need, off = ehdr + elen, 0
        else:
            elen = 4 + (len6 & 7) if kind == 1 else (len6 & 63) + 1
            off = (((tag >> 5) << 8) | b1 if kind == 1
                   else b1 | (b2 << 8) if kind == 2
                   else b1 | (b2 << 8) | (b3 << 16) | (b4 << 24))
            in_need = ehdr = 2 if kind == 1 else 3 if kind == 2 else 5
        if (cur + in_need > clen or op + elen > ulen
                or (kind != 0 and not 1 <= off <= op)):
            return False
        if kind == 0:
            src = row[cur + ehdr: cur + ehdr + elen]
            out[op: op + len(src)] = src  # bytes past the row stay 0
        else:  # an overlapping copy repeats the last `off` bytes
            period = out[op - off: op]
            out[op: op + elen] = (period * (elen // off + 1))[:elen]
        cur += in_need
        op += elen
    return good and cur == clen and op == ulen


def _decode_plain(comp, comp_len, out_len, S_max):
    """Plain version of kernel F: one host walk per chunk."""
    C = comp.shape[0]
    rows = comp.numpy()
    out = np.zeros((C, S_max), np.uint8)
    ok = np.zeros(C, bool)
    for c in range(C):
        buf = bytearray(S_max)
        ok[c] = _decode_row(rows[c].tobytes(), int(comp_len[c]),
                            int(out_len[c]), S_max, buf)
        out[c] = np.frombuffer(buf, np.uint8)
    return torch.from_numpy(out), torch.from_numpy(ok)
