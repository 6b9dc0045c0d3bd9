"""Carry the reference package's settings and intermediate arrays, given as
numpy, into the port's types, so a test can feed each stage of the port the
reference's own inputs and a mismatch points at one stage.

Also the port's table of encoder settings per effort level.
"""

from __future__ import annotations

import numpy as np
import torch

from hap_tpu_torch.snappy.device_lz import LzPlan
from hap_tpu_torch.snappy.optable import PackedTables

# effort -> (BC1 refine rounds, endpoint candidate search)
_EFFORT = {"best": (2, True), "high": (2, False), "fast": (1, False)}


def encode_settings(effort: str):
    """(refine_iters, candidates) of an effort level, as the reference
    encoder uses them."""
    if effort not in _EFFORT:
        raise ValueError(f"effort {effort!r}: expected one of {list(_EFFORT)}")
    return _EFFORT[effort]


def _i32(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype in (np.uint32, np.int32):
        a = a.view(np.int32)
    else:
        raise TypeError(f"expected 32-bit integers, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def lz_plan_from_numpy(tables_lit, tables_copy, counts, comp_len, n_pieces,
                       device="cpu") -> LzPlan:
    """The reference planner's outputs (numpy int32) -> the port's LzPlan."""
    return LzPlan(*(_i32(a, device) for a in
                    (tables_lit, tables_copy, counts, comp_len, n_pieces)))


def words_from_numpy(words, device="cpu") -> torch.Tensor:
    """uint32 payload words -> the port's int32 words (same bits)."""
    return _i32(words, device)


def packed_tables_from_numpy(p, device="cpu") -> PackedTables:
    """The reference compiler's PackedTables (numpy fields) -> the port's
    PackedTables (tensors), so kernel G can replay the reference's own
    tables."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(
            device)

    return PackedTables(ops=_i32(p.ops, device), n_ops=_i32(p.n_ops, device),
                        lit=t(p.lit, np.uint8), n_lit=_i32(p.n_lit, device),
                        out_len=_i32(p.out_len, device), ok=t(p.ok, np.bool_),
                        S_max=int(p.S_max))
