"""The structured (RLE) Snappy profile: the second stage with
``HAP_TPU_DEVICE_LZ=0``.

Every stream is conforming Snappy, but its element structure is fixed so
that both directions run unit-parallel: the chunk is cut into 4096-byte
units, and each unit is emitted as one of

* ``literal``: a 3-byte literal tag (length 4096) and the unit's bytes;
* ``copy``: 64 back-to-back copy-2 elements (offset G, length 64), 192
  bytes: the unit repeats the G bytes before it (a G-periodic run);
* ``seeded``: the first unit of a G-periodic chunk, which has no history:
  a G-byte literal seed, then copy-2 elements for the remaining U - G
  bytes.

The sub-unit tail (S mod 4096 bytes, a multiple of G) has the same three
flavors with sizes derived from its length: a tail copy when there are
full units before it, a seeded tail when it is the whole chunk and longer
than G, otherwise a literal. All sizes are static given S and G, and the
flavors' sizes are distinct, so a unit's emission size alone names its
flavor.

Encode: the per-unit periodicity test (``_unit_sizes``, torch ops), byte
positions as an exclusive cumsum, then kernel E
(``rle_kernels.compact_streams_from_data``) composes and places every
unit's emission. Decode: kernel D(ii)
(``rle_kernels.decode_rle_streams_from_frame``) walks the units and checks
every tag byte against its static pattern.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

_I32 = torch.int32
_U8 = torch.uint8

_UNIT = 4096  # output bytes per full unit


def _varint_bytes(value: int) -> np.ndarray:
    out = []
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | 0x80 if value else b)
        if not value:
            return np.array(out, dtype=np.uint8)


def _lit_tag_bytes(length: int) -> np.ndarray:
    """Literal tag bytes for a literal of ``length`` payload bytes."""
    n = length - 1
    if n < 60:
        return np.array([n << 2], dtype=np.uint8)
    if n < 256:
        return np.array([60 << 2, n], dtype=np.uint8)
    if n >= 65536:
        raise ValueError(f"literal of {length} bytes needs a 4-byte tag")
    return np.array([61 << 2, n & 0xFF, n >> 8], dtype=np.uint8)


def _copy_run_bytes(L: int, G: int) -> np.ndarray:
    """copy-2 elements (offset G) covering L output bytes; L % G == 0,
    L > 0."""
    nel = -(-L // 64)
    lens = [64] * (nel - 1) + [L - 64 * (nel - 1)]
    return np.concatenate(
        [np.array([2 | ((n - 1) << 2), G & 0xFF, G >> 8], np.uint8)
         for n in lens])


_EMPTY = np.zeros(0, np.uint8)


class Profile(NamedTuple):
    """Static stream-structure facts for a (S, G) chunk shape."""

    U: int
    n_full: int               # full units
    tail: int                 # S - n_full * U (multiple of G, < U)
    pre: np.ndarray           # varint(S)
    lit_hdr: int              # 3: full-unit literal tag length
    emit_max: int             # U + lit_hdr (worst per-unit emission)
    copy_pat: np.ndarray      # full-unit copy elements (192 bytes)
    seed_pat: np.ndarray      # seeded unit: seed tag, then the copies
    #                           that follow the G seed bytes
    seed_size: int            # 1 + G + len(seed_pat) - 1
    tail_hdr: np.ndarray      # tail literal tag (empty without a tail)
    tail_lit_size: int
    tail_copy_pat: np.ndarray
    tail_seed_pat: np.ndarray  # empty unless the tail is seeded-capable
    tail_seed_size: int
    bound: int                # worst-case stream size

    @property
    def n_units(self) -> int:
        return self.n_full + (1 if self.tail else 0)


@functools.lru_cache(maxsize=None)
def profile(S: int, G: int) -> Profile:
    """The profile of a (S, G) chunk shape. Cached: every encode and
    decode asks for it, and building the patterns costs about 0.4 ms of
    host time at 4K. The arrays are shared; do not modify them."""
    if S % G or G not in (8, 16) or S <= 0:
        raise ValueError(f"chunk of {S} bytes with {G}-byte blocks")
    U = _UNIT
    n_full = S // U
    tail = S - n_full * U
    pre = _varint_bytes(S)
    lit_hdr = len(_lit_tag_bytes(U))
    emit_max = U + lit_hdr
    copy_pat = _copy_run_bytes(U, G)
    seed_tag = np.array([(G - 1) << 2], np.uint8)
    seed_copies = _copy_run_bytes(U - G, G)
    seed_pat = np.concatenate([seed_tag, seed_copies])
    seed_size = 1 + G + len(seed_copies)
    tail_hdr, tail_lit_size = _EMPTY, 0
    tail_copy_pat, tail_seed_pat, tail_seed_size = _EMPTY, _EMPTY, 0
    if tail:
        tail_hdr = _lit_tag_bytes(tail)
        tail_lit_size = len(tail_hdr) + tail
        tail_copy_pat = _copy_run_bytes(tail, G)
        tail_seed_size = tail_lit_size  # unused unless tail > G
        if tail > G:
            t_seed_copies = _copy_run_bytes(tail - G, G)
            tail_seed_pat = np.concatenate([seed_tag, t_seed_copies])
            tail_seed_size = 1 + G + len(t_seed_copies)
    bound = len(pre) + n_full * emit_max + tail_lit_size
    return Profile(U, n_full, tail, pre, lit_hdr, emit_max, copy_pat,
                   seed_pat, seed_size, tail_hdr, tail_lit_size,
                   tail_copy_pat, tail_seed_pat, tail_seed_size, bound)


def _periodic(units: torch.Tensor, ref_g: torch.Tensor) -> torch.Tensor:
    """units (..., k, G) == ref_g (..., 1, G) tiled -> (...) bool."""
    return (units == ref_g).all(dim=-1).all(dim=-1)


def _unit_sizes(data: torch.Tensor, S: int, G: int) -> torch.Tensor:
    """(C, S) uint8 -> (C, n_units) int32 per-unit emission sizes.

    A unit is a run when it is G-periodic against the G bytes before it
    (unit 0, and a tail that is the whole chunk, against their own first G
    bytes); the size alone names the flavor."""
    p = profile(S, G)
    C = data.shape[0]
    U, n_full, tail = p.U, p.n_full, p.tail
    sizes = []
    if n_full:
        units = data[:, :n_full * U].reshape(C, n_full, U // G, G)
        prevg = torch.cat([units[:, :1, :1, :], units[:, :-1, -1:, :]], 1)
        is_run = _periodic(units, prevg)
        size = torch.where(is_run, len(p.copy_pat), p.emit_max)
        size[:, 0] = torch.where(is_run[:, 0], p.seed_size, p.emit_max)
        sizes.append(size)
    if tail:
        tunits = data[:, n_full * U:].reshape(C, tail // G, G)
        t_size = torch.full((C,), p.tail_lit_size, dtype=torch.int64,
                            device=data.device)
        if n_full:
            prevg_t = data[:, n_full * U - G: n_full * U].reshape(C, 1, G)
            t_size = torch.where(_periodic(tunits, prevg_t),
                                 len(p.tail_copy_pat), t_size)
        elif tail > G:
            t_size = torch.where(_periodic(tunits, tunits[:, :1, :]),
                                 p.tail_seed_size, t_size)
        sizes.append(t_size[:, None])
    return torch.cat(sizes, dim=1).to(_I32)


def _run_pattern(p: Profile, first: bool, is_tail: bool, G: int):
    """(pattern bytes, seeded) of a unit's run emission: a seeded pattern
    leaves a gap of G seed bytes after its first byte."""
    if is_tail and p.n_full:
        return p.tail_copy_pat, False
    if is_tail:
        return p.tail_seed_pat, len(p.tail_seed_pat) > 0
    if first:
        return p.seed_pat, True
    return p.copy_pat, False


def _build_emissions(data: torch.Tensor, S: int, G: int,
                     sizes: torch.Tensor | None = None):
    """(C, S) uint8 -> (emit (C, n_units, emit_max) uint8, sizes (C,
    n_units) int32).

    Each unit's emission is its literal (tag, then its bytes) when its
    size is the literal size, else its run pattern (with the G seed bytes
    after the seed tag for a seeded unit); bytes past the composition are
    0. ``sizes`` defaults to ``_unit_sizes(data)``; given, it picks the
    flavors as kernel E does."""
    p = profile(S, G)
    if sizes is None:
        sizes = _unit_sizes(data, S, G)
    C, dev = data.shape[0], data.device
    emit = torch.zeros((C, p.n_units, p.emit_max), dtype=_U8, device=dev)
    for u in range(p.n_units):
        is_tail = u == p.n_full
        start = u * p.U
        length = p.tail if is_tail else p.U
        hdr = p.tail_hdr if is_tail else _lit_tag_bytes(p.U)
        lit_size = p.tail_lit_size if is_tail else p.emit_max
        lit = torch.zeros((C, p.emit_max), dtype=_U8, device=dev)
        lit[:, :len(hdr)] = torch.from_numpy(hdr).to(dev)
        lit[:, len(hdr): len(hdr) + length] = data[:, start: start + length]
        pat, seeded = _run_pattern(p, u == 0, is_tail, G)
        run = torch.zeros((C, p.emit_max), dtype=_U8, device=dev)
        if seeded:
            run[:, :1] = torch.from_numpy(pat[:1]).to(dev)
            run[:, 1: 1 + G] = data[:, start: start + G]
            run[:, 1 + G: G + len(pat)] = torch.from_numpy(pat[1:]).to(dev)
        else:
            run[:, :len(pat)] = torch.from_numpy(pat).to(dev)
        emit[:, u] = torch.where((sizes[:, u] == lit_size)[:, None], lit, run)
    return emit, sizes


def _positions(sizes: torch.Tensor, P: int):
    """Per-unit stream positions (P + exclusive cumsum) and stream
    lengths."""
    csum = torch.cumsum(sizes, dim=1, dtype=_I32)
    return (P + csum - sizes).to(_I32), (P + csum[:, -1]).to(_I32)


def snappy_encode_chunks(data: torch.Tensor, S: int, G: int):
    """(C, S) uint8 -> ((C, bound) uint8 streams, (C,) int32 lengths).

    Every stream is a conforming Snappy encoding of its row in this
    profile; bytes past its length are 0. Kernel E places the unit
    emissions; the varint(S) preamble is written after it."""
    from hap_tpu_torch.snappy.rle_kernels import compact_streams_from_data

    p = profile(S, G)
    P = len(p.pre)
    sizes = _unit_sizes(data, S, G)
    positions, comp_len = _positions(sizes, P)
    out = compact_streams_from_data(data, positions, sizes, S, G, p.bound)
    out[:, :P] = torch.from_numpy(p.pre).to(out.device)
    return out, comp_len


def snappy_decode_chunks(comp: torch.Tensor, comp_len: torch.Tensor, S: int,
                         G: int):
    """((C, B) uint8 streams, (C,) int32 lengths) -> ((C, S) uint8, (C,)
    bool ok).

    The streams are read as one buffer at stride B, as the frame-direct
    decode reads a frame; ok is False for a stream outside this profile
    (or malformed), whose row is then 0."""
    from hap_tpu_torch.snappy.rle_kernels import decode_rle_streams_from_frame
    from hap_tpu_torch.snappy.stream_kernels import raw_chunks_from_frame

    C, B = comp.shape
    dev = comp.device
    pos = torch.arange(C, dtype=_I32, device=dev) * B
    is_comp = torch.ones(C, dtype=torch.bool, device=dev)
    flat = comp.reshape(-1)
    out, ok = raw_chunks_from_frame(flat, pos, comp_len, is_comp, S)
    decode_rle_streams_from_frame(flat, pos, comp_len, is_comp, S, G, out, ok)
    return out, ok
