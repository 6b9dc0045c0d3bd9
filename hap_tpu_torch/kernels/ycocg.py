"""Scaled YCoCg (Hap Q's colour space) on lane-major block planes.

Same arithmetic as the reference: the per-block scale (1, 2 or 4) is picked
from the chroma amplitude and stored in the third CoCg plane as
(scale - 1) * 8; every step is exact in float32, so results match bit for
bit.
"""

from __future__ import annotations

import torch

_OFFSET = 128.0  # chroma zero point in 8-bit space


def rgb_to_cocgs_y_planes(rgb_planes: torch.Tensor):
    """(3, 16, N) uint8 RGB planes -> ((3, 16, N) float32 CoCg_scale planes,
    (16, N) float32 Y), rounded and clipped to byte values."""
    r, g, b = (rgb_planes[i].to(torch.float32) for i in range(3))
    co = r - b
    t = b + co * 0.5
    cg = g - t
    y = t + cg * 0.5
    amp = torch.maximum(co.abs().amax(dim=0), cg.abs().amax(dim=0))
    half_amp = amp * 0.5
    scale = torch.where(half_amp < 32.0, 4.0,
                        torch.where(half_amp < 64.0, 2.0, 1.0))
    s = scale[None, :]
    co_b = torch.clamp(torch.round(co * 0.5 * s + _OFFSET), 0, 255)
    cg_b = torch.clamp(torch.round(cg * 0.5 * s + _OFFSET), 0, 255)
    scale_b = ((scale - 1.0) * 8.0)[None, :].expand_as(co_b)
    y_b = torch.clamp(torch.round(y), 0, 255)
    return torch.stack([co_b, cg_b, scale_b]), y_b


def cocgs_y_to_rgb_planes_f32(cocgs: torch.Tensor, y: torch.Tensor
                              ) -> torch.Tensor:
    """((3, 16, N) CoCg_scale planes, (16, N) Y) -> (3, 16, N) integer-valued
    float32 RGB (before the uint8 cast)."""
    sb = cocgs[2]  # (scale - 1) * 8 in {0, 8, 24}
    inv2 = torch.where(sb < 4.0, 2.0, torch.where(sb < 16.0, 1.0, 0.5))
    co = (cocgs[0] - _OFFSET) * inv2
    cg = (cocgs[1] - _OFFSET) * inv2
    t = y - cg * 0.5
    g = cg + t
    b = t - co * 0.5
    r = b + co
    return torch.clamp(torch.round(torch.stack([r, g, b])), 0, 255)


def cocgs_y_to_rgb_planes(cocgs: torch.Tensor, y: torch.Tensor
                          ) -> torch.Tensor:
    """As cocgs_y_to_rgb_planes_f32, cast to (3, 16, N) uint8."""
    return cocgs_y_to_rgb_planes_f32(cocgs, y).to(torch.uint8)
