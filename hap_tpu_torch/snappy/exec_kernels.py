"""Kernel G: the op-table executor of the foreign-frame "table" route.

``execute_op_tables`` launches ``csrc/exec_tables.cu`` for CUDA tensors and
runs its plain PyTorch version for CPU tensors; there is no other
fallback. ``EXEC_TABLES.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from hap_tpu_torch._build import CudaKernel, check_tensor, current_stream

_P, _I = ctypes.c_void_p, ctypes.c_int

EXEC_TABLES = CudaKernel(
    "exec_tables", "exec_tables.cu", "hap_exec_tables",
    # ops, nops, n_ops, lit, L, out_len, out, S_max, C
    [_P, _I, _P, _P, _I, _P, _P, _I, _I])


def execute_op_tables(ops: torch.Tensor, n_ops: torch.Tensor,
                      lit: torch.Tensor, out_len: torch.Tensor, S_max: int,
                      out_words: bool = False) -> torch.Tensor:
    """Replay C piece tables into decoded rows.

    ops (C, NOPS, 2) int32 ``optable.pack_fields`` words packed for this
    ``S_max``; n_ops, out_len (C,) int32; lit (C, L) uint8 literal planes.
    Returns (C, S_max) uint8, or with ``out_words`` (S_max % 4 == 0) the
    same bytes as (C, S_max // 4) int32 little-endian words. Bytes
    [out_len, S_max) of each row are 0. The kernel cannot fail: a row whose
    table is malformed holds garbage, and rows of rejected streams must be
    passed with n_ops == 0 (the caller carries the host verdict)."""
    C, nops = ops.shape[0], ops.shape[1]
    if out_words and S_max % 4:
        raise ValueError(f"out_words needs S_max % 4 == 0, got {S_max}")
    if not ops.is_cuda:
        out = _execute_plain(ops, n_ops, lit, out_len, S_max)
        return out.view(torch.int32) if out_words else out
    dev = ops.device
    L = lit.shape[1]
    check_tensor(ops, "ops", torch.int32, (C, nops, 2), dev)
    check_tensor(n_ops, "n_ops", torch.int32, (C,), dev)
    check_tensor(lit, "lit", torch.uint8, (C, L), dev)
    check_tensor(out_len, "out_len", torch.int32, (C,), dev)
    if out_words:
        out = torch.empty((C, S_max // 4), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((C, S_max), dtype=torch.uint8, device=dev)
    EXEC_TABLES(ops.data_ptr(), nops, n_ops.data_ptr(), lit.data_ptr(), L,
                out_len.data_ptr(), out.data_ptr(), S_max, C,
                stream=current_stream(ops))
    return out


def _execute_plain(ops, n_ops, lit, out_len, S_max):
    """Plain version of kernel G: the pieces of all chunks in lockstep, one
    piece index per step (gather the sources, then scatter the bytes), with
    the kernel's clamps; column S_max of the work row takes the writes that
    the kernel drops."""
    C, nops = ops.shape[0], ops.shape[1]
    L = lit.shape[1]
    nout = -(-S_max // 128)
    out = torch.zeros((C, S_max + 1), dtype=torch.uint8)
    litp = lit if L else torch.zeros((C, 1), dtype=torch.uint8)
    n = n_ops.to(torch.int64).clamp(0, nops)
    j = torch.arange(128)
    b = torch.zeros(C, dtype=torch.int64)
    for k in range(int(n.max()) if C else 0):
        live = k < n
        w0, w1 = ops[:, k, 0].to(torch.int64), ops[:, k, 1].to(torch.int64)
        # invert optable.pack_fields: destination, length, source
        pa = w0 & 127
        m = ((w0 >> 7) & 255) - pa
        end = (w0 >> 15) & 1
        near = ((w0 >> 16) & 1) == 1
        srcl = (pa - ((w0 >> 17) & 255)) & 255
        is_lit = ~near & (w1 >= nout)
        dst = b * 128 + pa
        src = torch.where(near, dst - (128 + pa - srcl),
                          w1 * 128 + srcl - is_lit * nout * 128)
        s = src[:, None] + j
        from_out = out.gather(1, s.clamp(0, S_max - 1))
        from_lit = litp.gather(1, s.clamp(0, litp.shape[1] - 1))
        vals = torch.where(is_lit[:, None], from_lit, from_out)
        d = dst[:, None] + j
        keep = live[:, None] & (j < m[:, None]) & (d >= 0) & (d < S_max)
        out.scatter_(1, torch.where(keep, d, S_max), vals)
        b += end * live
    out = out[:, :S_max].contiguous()
    ol = out_len.to(torch.int64).clamp(0, S_max)
    out[torch.arange(S_max)[None, :] >= ol[:, None]] = 0
    return out
