"""Stream-structure facts of the reference's structured (RLE) Snappy
profile, kept only because the frame layout's per-chunk bound covers both
profiles: a frame's shape does not depend on which profile wrote it."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_UNIT = 4096  # output bytes per full unit


def _varint_bytes(value: int) -> np.ndarray:
    out = []
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | 0x80 if value else b)
        if not value:
            return np.array(out, dtype=np.uint8)


def _lit_tag_len(length: int) -> int:
    n = length - 1
    return 1 if n < 60 else 2 if n < 256 else 3


class Profile(NamedTuple):
    """Static stream-structure facts for a (S, G) chunk shape."""

    U: int
    n_full: int          # full units
    tail: int            # S - n_full * U
    pre: np.ndarray      # varint(S)
    lit_hdr: int         # full-unit literal tag length
    emit_max: int        # worst per-unit emission
    tail_lit_size: int   # tail literal tag + bytes
    bound: int           # worst-case stream size


def profile(S: int, G: int) -> Profile:
    if S % G or G not in (8, 16):
        raise ValueError(f"chunk of {S} bytes with {G}-byte blocks")
    U = _UNIT
    n_full = S // U
    tail = S - n_full * U
    pre = _varint_bytes(S)
    lit_hdr = _lit_tag_len(U)
    emit_max = U + lit_hdr
    tail_lit_size = _lit_tag_len(tail) + tail if tail else 0
    bound = len(pre) + n_full * emit_max + tail_lit_size
    return Profile(U, n_full, tail, pre, lit_hdr, emit_max, tail_lit_size,
                   bound)

