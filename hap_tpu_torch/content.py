"""Deterministic frame content in three classes (numpy only).

A copy of the reference repository's benchmark content generator, so that
the smoke run on the GPU needs nothing outside this package:

* ``natural``  -- smooth multi-frequency fields + film grain;
* ``graphics`` -- flat panels, gradients, hard edges, text-like stripes;
* ``noise``    -- broadband noise (worst case for the second stage).

Every frame is a deterministic function of (cls, seed, H, W).
"""

from __future__ import annotations

import zlib

import numpy as np


def make_frame(cls: str, seed: int, H: int, W: int) -> np.ndarray:
    # zlib.crc32, not hash(): string hashing is randomized per process.
    rng = np.random.default_rng(1000 * seed + zlib.crc32(cls.encode()) % 997)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    if cls == "natural":
        f = rng.uniform(30, 130, 6)
        ph = rng.uniform(0, 6.28, 6)
        img = np.stack(
            [
                128 + 70 * np.sin(xx / f[0] + ph[0]) * np.cos(yy / f[1] + ph[1])
                + 30 * np.sin((xx + 2 * yy) / f[2] + ph[2]),
                128 + 70 * np.cos(xx / f[3] + ph[3]) * np.sin(yy / f[4] + ph[4]),
                128 + 90 * np.sin((xx - yy) / f[5] + ph[5]),
            ],
            axis=-1,
        )
        # film grain on the textured part; the top quarter is a smooth sky
        # gradient (constant along x, so blocks repeat and the second stage
        # engages)
        img += rng.normal(0, rng.uniform(0.5, 2.0), (H, W, 3))
        sky = 40 + 160 * (yy[: H // 4, :1] / (H // 4))
        img[: H // 4] = sky[..., None] * rng.uniform(0.6, 1.0, 3)
    elif cls == "graphics":
        img = np.zeros((H, W, 3), np.float32)
        img[:] = (
            np.linspace(0, 255, W, dtype=np.float32)[None, :, None]
            * rng.uniform(0.3, 1.0, 3)[None, None, :]
        )
        for _ in range(8):
            y0, x0 = rng.integers(0, H - H // 6), rng.integers(0, W - W // 6)
            h, w = rng.integers(H // 12, H // 6), rng.integers(W // 12, W // 6)
            img[y0 : y0 + h, x0 : x0 + w] = rng.integers(0, 256, 3)
        rows = slice(H // 8, H // 8 + H // 16)
        stripe = (xx[rows] % rng.integers(6, 16) < 3) * 255.0
        img[rows] = stripe[..., None]
    elif cls == "noise":
        amp = rng.uniform(40, 128)
        img = 128 + rng.normal(0, amp, (H, W, 3)).astype(np.float32)
        # half-frame structured so per-chunk fallbacks mix within one frame
        img[: H // 2] = 128 + 60 * np.sin(xx[: H // 2] / 41.0)[..., None]
    else:
        raise ValueError(cls)

    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def make_gop(n: int, H: int, W: int) -> np.ndarray:
    """n distinct frames cycling through the content classes."""
    classes = ["natural", "graphics", "noise"]
    return np.stack(
        [make_frame(classes[i % 3], i, H, W) for i in range(n)]
    )
