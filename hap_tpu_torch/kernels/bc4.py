"""BC4 (RGTC1) single-channel block codec on lane-major planes.

An 8-byte block = endpoints a0, a1 (bytes) + 48 bits of 3-bit codes, texel
0 in the low bits. Word 0 holds a0 | a1 << 8 | code bits 0..15 << 16, word
1 holds code bits 16..47. Palette for a0 > a1 (the only mode the encoder
emits): code 0 -> a0, 1 -> a1, k in 2..7 -> ((8-k)*a0 + (k-1)*a1 + 3) // 7;
for a0 <= a1 (decode only): k in 2..5 -> ((6-k)*a0 + (k-1)*a1 + 2) // 5,
6 -> 0, 7 -> 255.

Same arithmetic as the reference: the palette is exact float32 floor math,
the code quantization is one true float32 division, and the least-squares
refit is exact integer arithmetic, so the words match bit for bit.
"""

from __future__ import annotations

import torch

from hap_tpu_torch.kernels.layout import wrap_int32



def _shift3(device) -> torch.Tensor:
    """(16, 1) bit offsets of the 3-bit codes (made on the device: no
    host-to-device copy)."""
    return (torch.arange(16, dtype=torch.int64, device=device) * 3)[:, None]


def _codes(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """(N,) int32 word pair -> (16, N) int32 3-bit codes."""
    field = ((w0.to(torch.int64) >> 16) & 0xFFFF) | (
        (w1.to(torch.int64) & 0xFFFFFFFF) << 16)
    return ((field[None, :] >> _shift3(w0.device)) & 7).to(torch.int32)


def bc4_decode_planes(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """((N,), (N,)) int32 BC4 words -> (16, N) float32 channel plane, both
    interpolation modes."""
    a0 = (w0 & 0xFF).to(torch.float32)[None, :]
    a1 = ((w0 >> 8) & 0xFF).to(torch.float32)[None, :]
    k = _codes(w0, w1)
    kf = k.to(torch.float32)
    wa7 = torch.where(k == 0, 7.0, torch.where(k == 1, 0.0, 8.0 - kf))
    v7 = torch.floor((wa7 * a0 + (7.0 - wa7) * a1 + 3.0) * (1.0 / 7.0))
    wa5 = torch.where(k == 0, 5.0, torch.where(
        k == 1, 0.0, torch.clamp(6.0 - kf, min=0.0)))
    v5 = torch.floor((wa5 * a0 + (5.0 - wa5) * a1 + 2.0) * (1.0 / 5.0))
    v5 = torch.where(k == 6, 0.0, torch.where(k == 7, 255.0, v5))
    return torch.where(a0 > a1, v7, v5)


def _quantize(e0: torch.Tensor, e1: torch.Tensor, vT: torch.Tensor):
    """Endpoints (float, (N,)) -> (a0, a1, codes): round, order a0 >= a1,
    and pick each texel's nearest ladder position by one division."""
    a0 = torch.clamp(torch.round(e0), 0, 255).to(torch.int32)
    a1 = torch.clamp(torch.round(e1), 0, 255).to(torch.int32)
    a0, a1 = torch.maximum(a0, a1), torch.minimum(a0, a1)
    d = torch.clamp((a0 - a1).to(torch.float32), min=1.0)
    m = torch.floor((a0.to(torch.float32)[None, :] - vT) * 7.0 / d[None, :]
                    + 0.5)
    m = torch.clamp(m, 0.0, 7.0).to(torch.int32)  # ladder position
    codes = torch.where(m == 0, 0, torch.where(m == 7, 1, m + 1))
    codes = torch.where((a0 == a1)[None, :], 0, codes)
    return a0, a1, codes


def _div_round(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Round-half-away-from-zero n / d for d > 0, exact in int32."""
    return torch.where(n >= 0, (2 * n + d) // (2 * d),
                       -((-2 * n + d) // (2 * d)))


def bc4_encode_planes_words(plane: torch.Tensor, refine_iters: int = 1,
                            candidates: bool = False):
    """(16, N) float/uint8 channel plane -> ((N,), (N,)) int32 BC4 words.

    Endpoint seed = block max/min, then ``refine_iters`` exact-integer
    least-squares refits. The reference's ``candidates`` search (effort
    "best") is not part of this port yet."""
    if candidates:
        raise NotImplementedError("BC4 endpoint candidates (effort='best')")
    vT = plane.to(torch.float32)
    a0, a1, codes = _quantize(vT.amax(dim=0), vT.amin(dim=0), vT)
    viT = torch.round(vT).to(torch.int32)
    sv = viT.sum(dim=0, dtype=torch.int32)
    for _ in range(refine_iters):
        # normal equations scaled by 7 / 49 into integers (weights k/7)
        w7 = torch.where(codes == 0, 0, torch.where(codes == 1, 7, codes - 1))
        sw7 = w7.sum(dim=0, dtype=torch.int32)
        g49 = (w7 * w7).sum(dim=0, dtype=torch.int32)
        b49 = 7 * sw7 - g49
        a49 = 16 * 49 - 14 * sw7 + g49
        r1_7 = (w7 * viT).sum(dim=0, dtype=torch.int32)
        r0_7 = 7 * sv - r1_7
        det = a49 * g49 - b49 * b49
        n0 = 7 * (g49 * r0_7 - b49 * r1_7)
        n1 = 7 * (a49 * r1_7 - b49 * r0_7)
        ok = det > 0
        dsafe = torch.where(ok, det, 1)
        a0n = torch.where(ok, torch.clamp(_div_round(n0, dsafe), 0, 255), a0)
        a1n = torch.where(ok, torch.clamp(_div_round(n1, dsafe), 0, 255), a1)
        a0, a1, codes = _quantize(a0n.to(torch.float32),
                                  a1n.to(torch.float32), vT)
    return _pack_codes3(codes, a0, a1)


def _pack_codes3(codes: torch.Tensor, a0: torch.Tensor, a1: torch.Tensor):
    """(16, N) 3-bit codes + endpoints -> ((N,), (N,)) int32 words."""
    field = (codes.to(torch.int64) << _shift3(codes.device)).sum(dim=0)  # 48 bits
    w0 = (a0.to(torch.int64) | (a1.to(torch.int64) << 8)
          | ((field & 0xFFFF) << 16))
    return wrap_int32(w0), wrap_int32(field >> 16)
