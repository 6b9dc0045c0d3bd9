"""Kernels B and D: frame stitch and raw-chunk copy out of a frame.

Each wrapper launches its CUDA kernel (``csrc/stitch.cu``,
``csrc/raw_chunks.cu``) for CUDA tensors and runs its plain version for CPU
tensors; there is no other fallback. ``STITCH.launches`` and
``RAW_CHUNKS.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from hap_tpu_torch._build import CudaKernel, check_tensor, current_stream

_P, _I = ctypes.c_void_p, ctypes.c_int

STITCH = CudaKernel(
    "stitch", "stitch.cu", "hap_stitch",
    # header, header_len, comp, comp_stride, chunks, chunk_stride,
    # src_comp, q, lengths, C, out, out_len
    [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, ctypes.c_longlong])

RAW_CHUNKS = CudaKernel(
    "raw_chunks_from_frame", "raw_chunks.cu", "hap_raw_chunks",
    # frame, frame_len, pos, csizes, is_comp, out, ok, C, S
    [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _I, _I])

# The stitch kernel stages the chunk tables in shared memory.
_STITCH_MAX_CHUNKS = 4096


def stitch_streams(header: torch.Tensor, header_len: torch.Tensor,
                   comp: torch.Tensor, chunks: torch.Tensor,
                   src_comp: torch.Tensor, q: torch.Tensor,
                   lengths: torch.Tensor, out_len: int) -> torch.Tensor:
    """Ragged back-to-back concatenation of C chunk streams into one frame.

    Returns (out_len,) uint8: ``header[:header_len]`` at 0, then for each
    chunk c the first ``lengths[c]`` bytes of ``comp[c]`` (if
    ``src_comp[c]``) or ``chunks[c]`` at byte ``q[c]``; every other byte
    is 0. Chunks must lie in order, back to back, from ``header_len`` on.

    header (H,) uint8; header_len () int32; comp (C, B) uint8; chunks
    (C, S) uint8; src_comp (C,) bool; q, lengths (C,) int32."""
    if not comp.is_cuda:
        return _stitch_plain(header, header_len, comp, chunks, src_comp, q,
                             lengths, out_len)
    C, B = comp.shape
    S = chunks.shape[1]
    if C > _STITCH_MAX_CHUNKS:
        raise ValueError(f"stitch takes at most {_STITCH_MAX_CHUNKS} chunks")
    dev = comp.device
    check_tensor(header, "header", torch.uint8, (header.shape[0],), dev)
    check_tensor(header_len, "header_len", torch.int32, (), dev)
    check_tensor(comp, "comp", torch.uint8, (C, B), dev)
    check_tensor(chunks, "chunks", torch.uint8, (C, S), dev)
    check_tensor(src_comp, "src_comp", torch.bool, (C,), dev)
    check_tensor(q, "q", torch.int32, (C,), dev)
    check_tensor(lengths, "lengths", torch.int32, (C,), dev)
    out = torch.empty(out_len, dtype=torch.uint8, device=dev)
    STITCH(header.data_ptr(), header_len.data_ptr(), comp.data_ptr(), B,
           chunks.data_ptr(), S, src_comp.data_ptr(), q.data_ptr(),
           lengths.data_ptr(), C, out.data_ptr(), out_len,
           stream=current_stream(comp))
    return out


def _stitch_plain(header, header_len, comp, chunks, src_comp, q, lengths,
                  out_len):
    """Plain version of kernel B: slice assignments in chunk order."""
    out = torch.zeros(out_len, dtype=torch.uint8)
    h = int(header_len)
    out[:h] = header[:h]
    for c in range(comp.shape[0]):
        src = comp[c] if bool(src_comp[c]) else chunks[c]
        p, n = int(q[c]), int(lengths[c])
        out[p: p + n] = src[:n]
    return out


def raw_chunks_from_frame(frame: torch.Tensor, pos: torch.Tensor,
                          csizes: torch.Tensor, is_comp: torch.Tensor,
                          S: int):
    """Copy the raw (stored) chunks straight out of the frame.

    Returns ((C, S) uint8, (C,) bool ok). Row c of a raw chunk holds
    ``frame[pos[c] : pos[c] + S]`` (bytes outside the frame read as 0) and
    ``ok[c]`` is ``csizes[c] == S``: a stored chunk always holds exactly S
    bytes, so any other size-table entry is a corrupt frame. For chunks
    with ``is_comp[c]`` the row is left for the LZ decoder and ``ok[c]``
    is True."""
    C = pos.shape[0]
    if not frame.is_cuda:
        return _raw_chunks_plain(frame, pos, csizes, is_comp, S)
    dev = frame.device
    check_tensor(frame, "frame", torch.uint8, (frame.shape[0],), dev)
    check_tensor(pos, "pos", torch.int32, (C,), dev)
    check_tensor(csizes, "csizes", torch.int32, (C,), dev)
    check_tensor(is_comp, "is_comp", torch.bool, (C,), dev)
    out = torch.empty((C, S), dtype=torch.uint8, device=dev)
    ok = torch.empty(C, dtype=torch.bool, device=dev)
    RAW_CHUNKS(frame.data_ptr(), frame.shape[0], pos.data_ptr(),
               csizes.data_ptr(), is_comp.data_ptr(), out.data_ptr(),
               ok.data_ptr(), C, S, stream=current_stream(frame))
    return out, ok


def _raw_chunks_plain(frame, pos, csizes, is_comp, S):
    """Plain version of kernel D: one gather per chunk row."""
    F = frame.shape[0]
    idx = pos.to(torch.int64)[:, None] + torch.arange(S)[None, :]
    inside = (idx >= 0) & (idx < F)
    rows = torch.where(inside, frame[idx.clamp(0, max(F - 1, 0))], 0)
    out = torch.where(is_comp[:, None], 0, rows).to(torch.uint8)
    ok = is_comp | (csizes == S)
    return out, ok
