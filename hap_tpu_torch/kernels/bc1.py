"""BC1 (DXT1) block codec on lane-major planes.

An 8-byte block = two RGB565 endpoints (word 0: c0 | c1 << 16) + a 32-bit
field of 2-bit codes (word 1, texel 0 in the low bits). Decode rule:
2/3 interpolation = (2a + b + 1) // 3, 1/2 = (a + b + 1) // 2, computed as
exact float32 floor math, so decode matches the reference bit for bit.

Encode = PCA endpoint seed (power iteration on each block's 3x3
covariance) + projection index selection + float32 least-squares refits.
The float32 refit can round differently from the reference on tie blocks,
so encoded words may differ there; decoded quality matches.
"""

from __future__ import annotations

import torch

from hap_tpu_torch.kernels.layout import wrap_int32



def _shift2(device) -> torch.Tensor:
    """(16, 1) bit offsets of the 2-bit codes (made on the device)."""
    return (torch.arange(16, dtype=torch.int64, device=device) * 2)[:, None]


def expand565(c: torch.Tensor):
    """int32 RGB565 codes -> (r8, g8, b8) int32 with bit replication."""
    r5 = (c >> 11) & 0x1F
    g6 = (c >> 5) & 0x3F
    b5 = c & 0x1F
    return (r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)


def _weight_e0(codes: torch.Tensor) -> torch.Tensor:
    """4-colour palette weight toward e0, in thirds (codes 0/1 fold into
    the interpolation exactly: (3a + 1) // 3 == a)."""
    return torch.where(codes == 0, 3.0, torch.where(
        codes == 2, 2.0, torch.where(codes == 3, 1.0, 0.0)))


def bc1_decode_planes(w0: torch.Tensor, w1: torch.Tensor,
                      dxt1_punchthrough: bool = True):
    """((N,), (N,)) int32 BC1 words -> ((3, 16, N) float32 RGB planes,
    (16, N) bool opaque)."""
    c0 = w0 & 0xFFFF
    c1 = (w0 >> 16) & 0xFFFF
    codes = ((w1.to(torch.int64)[None, :] >> _shift2(w1.device)) & 3).to(torch.int32)
    e0 = [x.to(torch.float32)[None, :] for x in expand565(c0)]
    e1 = [x.to(torch.float32)[None, :] for x in expand565(c1)]
    ca = _weight_e0(codes)
    planes4 = [torch.floor((ca * a + (3.0 - ca) * b + 1.0) * (1.0 / 3.0))
               for a, b in zip(e0, e1)]
    if not dxt1_punchthrough:
        return torch.stack(planes4), torch.ones_like(codes, dtype=torch.bool)
    # 3-colour mode (c0 <= c1): codes {0,1,2,3} -> {e0, e1, (e0+e1+1)//2, 0}
    planes3 = [
        torch.where(codes == 0, a, torch.where(
            codes == 1, b, torch.where(
                codes == 2, torch.floor((a + b + 1.0) * 0.5), 0.0)))
        for a, b in zip(e0, e1)
    ]
    fc = (c0 > c1)[None, :]
    rgb = torch.stack([torch.where(fc, v4, v3)
                       for v4, v3 in zip(planes4, planes3)])
    return rgb, fc | (codes != 3)


def _quantize565(e) -> torch.Tensor:
    """[r, g, b] float (N,) planes -> int32 565 codes (N,)."""
    r = torch.round(torch.clamp(e[0], 0.0, 255.0) * (31.0 / 255.0))
    g = torch.round(torch.clamp(e[1], 0.0, 255.0) * (63.0 / 255.0))
    b = torch.round(torch.clamp(e[2], 0.0, 255.0) * (31.0 / 255.0))
    return ((r.to(torch.int32) << 11) | (g.to(torch.int32) << 5)
            | b.to(torch.int32))


def _quantize(e0, e1, ch):
    """Float endpoints -> (q0, q1, codes): 565 codes ordered q0 >= q1
    (4-colour mode) and each texel's code by projection onto the
    p0 -> p1 axis, thresholded at 1/6, 1/2, 5/6 (all exact in float32)."""
    q0, q1 = _quantize565(e0), _quantize565(e1)
    q0, q1 = torch.maximum(q0, q1), torch.minimum(q0, q1)
    p0, p1 = expand565(q0), expand565(q1)
    dd = [(b - a).to(torch.float32) for a, b in zip(p0, p1)]
    den = (dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])[None, :]
    t6 = 6.0 * sum((c - a.to(torch.float32)[None, :]) * d[None, :]
                   for c, a, d in zip(ch, p0, dd))
    codes = torch.where(t6 < den * 1.0, 0, torch.where(
        t6 < den * 3.0, 2, torch.where(t6 < den * 5.0, 3, 1))).to(torch.int32)
    codes = torch.where((q0 == q1)[None, :], 0, codes)
    return q0, q1, codes


def bc1_encode_planes_words(planes: torch.Tensor, refine_iters: int = 2,
                            candidates: bool = False):
    """(3, 16, N) float/uint8 RGB planes -> ((N,), (N,)) int32 BC1 words.

    The reference's ``candidates`` search (effort "best") is not part of
    this port yet."""
    if candidates:
        raise NotImplementedError("BC1 endpoint candidates (effort='best')")
    px = planes.to(torch.float32)
    ch = [px[0], px[1], px[2]]

    # PCA seed: power iteration on the per-block covariance entries
    means = [c.mean(dim=0) for c in ch]
    d = [c - m[None, :] for c, m in zip(ch, means)]
    cov = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            cov[i][j] = cov[j][i] = (d[i] * d[j]).sum(dim=0)
    v = [sum(cov[i][j].abs() for j in range(3)) + 1e-4 for i in range(3)]
    for _ in range(5):
        nv = [sum(cov[i][j] * v[j] for j in range(3)) for i in range(3)]
        norm = torch.rsqrt(sum(x * x for x in nv) + 1e-24)
        v = [x * norm for x in nv]
    t = sum(dc * vc[None, :] for dc, vc in zip(d, v))
    tmin, tmax = t.amin(dim=0), t.amax(dim=0)
    e0 = [m + vc * tmax for m, vc in zip(means, v)]  # e0 = high end
    e1 = [m + vc * tmin for m, vc in zip(means, v)]
    spx = [m * 16.0 for m in means]

    q0, q1, codes = _quantize(e0, e1, ch)
    for _ in range(refine_iters):
        w = ((codes == 1).to(torch.float32)
             + (codes == 2).to(torch.float32) * (1.0 / 3.0)
             + (codes == 3).to(torch.float32) * (2.0 / 3.0))  # weight of e1
        e0f = [x.to(torch.float32) for x in expand565(q0)]
        e1f = [x.to(torch.float32) for x in expand565(q1)]
        sw = w.sum(dim=0)
        gamma = (w * w).sum(dim=0)
        beta = sw - gamma
        alpha = 16.0 - 2.0 * sw + gamma
        det = alpha * gamma - beta * beta
        ok = det.abs() > 1e-4
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        e0n, e1n = [], []
        for ci in range(3):
            r1 = (w * ch[ci]).sum(dim=0)
            r0 = spx[ci] - r1
            e0n.append(torch.where(ok, (gamma * r0 - beta * r1) * inv_det,
                                   e0f[ci]))
            e1n.append(torch.where(ok, (alpha * r1 - beta * r0) * inv_det,
                                   e1f[ci]))
        q0, q1, codes = _quantize(e0n, e1n, ch)

    idx = (codes.to(torch.int64) << _shift2(codes.device)).sum(dim=0)
    w0 = q0.to(torch.int64) | (q1.to(torch.int64) << 16)
    return wrap_int32(w0), wrap_int32(idx)
