"""Host-side Snappy stream -> op-table compiler for kernel G.

A copy of the reference package's compiler (Python route only). The
parse/execute split of foreign-frame decode: the byte-serial tag walk is
host work, so the host compiles each stream into a table of uniform
pieces that the executor kernel (``exec_kernels.execute_op_tables``)
replays with no tag decode, no validation and no overlap handling.

Compilation steps per stream:

1. Walk elements, validating exactly as the decoders do (bounds, offset
   >= 1 and <= bytes produced, preamble == expected length, termination at
   the stream end): a malformed stream yields no table.
2. Compact all literal bytes into a dense plane (stream order).
3. Merge consecutive copies with equal offset, and consecutive literals.
4. Optionally promote copies shorter than ``promote_max`` to literal-plane
   bytes (the compiler decodes the stream to know them).
5. Expand every overlapping copy (off < min(m, 128)) into a doubling
   sequence of non-overlapping copies (off, off), (2 off, ...), ...
6. Split every op at 128-byte output-block boundaries and flag block ends.

Logical piece: int32 x 2 = [m | end_of_block << 8, off]; off == 0 means a
literal (source: the literal plane at the running literal cursor), off > 0
a copy from ``off`` bytes back. Every piece has 1 <= m <= 128, stays inside
one 128-byte output block, and has off == 0 or m <= off <= bytes produced.
``pack_fields`` turns pieces into the executor's two words.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hap_tpu_torch.snappy import pyref


@dataclass
class OpTable:
    ops: np.ndarray  # (N, 2) int32 [m | end<<8, off]; off == 0 -> literal
    lit: np.ndarray  # (L,) uint8 dense literal plane, stream order
    out_len: int  # decoded size (== validated varint preamble)


def _read_varint(view, pos: int, n: int) -> Tuple[Optional[int], int]:
    val = 0
    shift = 0
    for _ in range(5):
        if pos >= n:
            return None, pos
        b = view[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if b < 0x80:
            if val >= 1 << 32:
                return None, pos
            return val, pos
        shift += 7
    return None, pos


def build_op_table(stream: bytes, expected_len: Optional[int] = None,
                   promote_max: int = 0) -> Optional[OpTable]:
    """Compile one Snappy stream; None if it is malformed (the accept and
    reject surface of ``pyref.decompress``).

    ``promote_max``: copies shorter than this become literal-plane bytes
    (decoded with ``pyref.decompress``), where they merge with neighbouring
    literals -- fewer pieces for the executor's serial walk, more literal
    bytes."""
    view = memoryview(stream)
    n = len(view)
    out_len, pos = _read_varint(view, 0, n)
    if out_len is None:
        return None
    if expected_len is not None and out_len != expected_len:
        return None

    raw: List[Tuple[int, int]] = []  # (m, off)
    lit_parts: List[Tuple[int, int]] = []  # (start, len) into stream
    op = 0
    while pos < n:
        tag = view[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    return None
                length = int.from_bytes(view[pos:pos + extra], "little") + 1
                pos += extra
            if pos + length > n or op + length > out_len:
                return None
            lit_parts.append((pos, length))
            raw.append((length, 0))
            pos += length
            op += length
            continue
        if kind == 1:
            if pos + 1 > n:
                return None
            length = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | view[pos]
            pos += 1
        elif kind == 2:
            if pos + 2 > n:
                return None
            length = (tag >> 2) + 1
            off = view[pos] | (view[pos + 1] << 8)
            pos += 2
        else:
            if pos + 4 > n:
                return None
            length = (tag >> 2) + 1
            off = int.from_bytes(view[pos:pos + 4], "little")
            pos += 4
        if off < 1 or off > op or op + length > out_len:
            return None
        raw.append((length, off))
        op += length
    if op != out_len:
        return None

    # -- merge consecutive same-off copies / consecutive literals ---------
    merged: List[List[int]] = []
    for m, off in raw:
        if merged and merged[-1][1] == off:
            merged[-1][0] += m
        else:
            merged.append([m, off])

    # -- promote short copies to literals (needs the decoded bytes) -------
    decoded = None
    if promote_max > 0:
        decoded = np.frombuffer(pyref.decompress(stream), np.uint8)
        promoted: List[List[int]] = []
        for m, off in merged:
            if off > 0 and m < promote_max:
                off = 0
            if promoted and promoted[-1][1] == 0 and off == 0:
                promoted[-1][0] += m
            else:
                promoted.append([m, off])
        merged = promoted

    # -- expand overlap copies into a non-overlapping doubling sequence ---
    expanded: List[Tuple[int, int]] = []
    for m, off in merged:
        if off == 0 or off >= min(m, 128):
            expanded.append((m, off))
            continue
        cur_off, rem = off, m
        while rem > 0 and cur_off < 128:
            take = min(cur_off, rem)
            expanded.append((take, cur_off))
            rem -= take
            cur_off *= 2
        if rem > 0:
            expanded.append((rem, cur_off))

    # -- split at 128-byte output-block boundaries, flag block ends -------
    ops: List[Tuple[int, int]] = []
    pos = 0
    for m, off in expanded:
        while m > 0:
            take = min(m, 128 - (pos & 127))
            end = 1 if ((pos & 127) + take) == 128 else 0
            ops.append((take | (end << 8), off))
            pos += take
            m -= take

    if decoded is not None:
        # promoted bytes come from the decoded output, in stream order
        pieces = []
        pos_ = 0
        for m, off in merged:
            if off == 0:
                pieces.append(decoded[pos_: pos_ + m])
            pos_ += m
        lit = (np.concatenate(pieces) if pieces
               else np.empty(0, np.uint8)).astype(np.uint8)
    else:
        src = np.frombuffer(stream, np.uint8)
        lit = np.concatenate([src[a:a + ln] for a, ln in lit_parts]
                             ) if lit_parts else np.empty(0, np.uint8)
    return OpTable(ops=np.asarray(ops, np.int32).reshape(-1, 2), lit=lit,
                   out_len=out_len)


def pack_fields(ops_logical: np.ndarray, nout: int) -> np.ndarray:
    """Logical pieces [(m | end<<8, off)] -> executor field words.

    Every per-piece scalar the executor would otherwise derive serially is
    a function of the piece prefix, computed here:

      w0 = pa | pe<<7 | end<<15 | near<<16 | shift<<17   (25 bits)
      w1 = source row (far copy or literal; a near copy needs none)

    pa/pe: the piece's first and one-past-last byte in its 128-byte output
    block; near: a copy whose source starts at most one block back; srcl:
    the source's byte within its row (near: within the previous + current
    blocks, 0..255), kept as shift = (pa - srcl) mod 256. Rows >= ``nout``
    address the literal plane, so ``nout`` must equal ceil(S_max/128) of
    the executor call."""
    if ops_logical.size == 0:
        return ops_logical.reshape(-1, 2).astype(np.int32)
    w0 = ops_logical[:, 0].astype(np.int64)
    off = ops_logical[:, 1].astype(np.int64)
    m = w0 & 0xFF
    end = w0 >> 8
    outpos = np.concatenate(([0], np.cumsum(m[:-1])))
    pa = outpos & 127
    pe = pa + m
    is_lit = off == 0
    lc = np.concatenate(([0], np.cumsum((m * is_lit)[:-1])))
    s = np.where(is_lit, nout * 128 + lc, outpos - off)
    near = (~is_lit) & (off <= pa + 128)
    srcl = np.where(near, 128 + pa - off, s & 127)
    shift = (pa - srcl) % 256
    row0 = np.where(near, 0, s >> 7)
    packed = np.empty_like(ops_logical)
    packed[:, 0] = (pa | (pe << 7) | (end << 15) | (near << 16)
                    | (shift << 17)).astype(np.int32)
    packed[:, 1] = row0.astype(np.int32)
    return packed


@dataclass
class PackedTables:
    """Fixed-shape CPU tensors for a set of streams (kernel G's inputs).

    ops rows hold ``pack_fields`` words; rows of streams the compiler
    rejected have ok False and 0 ops, literals and output bytes."""

    ops: torch.Tensor  # (C, N_max, 2) int32, zero-padded
    n_ops: torch.Tensor  # (C,) int32
    lit: torch.Tensor  # (C, L_max) uint8, zero-padded
    n_lit: torch.Tensor  # (C,) int32
    out_len: torch.Tensor  # (C,) int32
    ok: torch.Tensor  # (C,) bool, the host verdict
    S_max: int  # the executor S_max these tables were packed for


def default_promote_max() -> int:
    """Literal-promotion threshold: copies shorter than this become
    literal-plane bytes. 128 is optimal for piece count (a copy and a
    literal of m >= 128 bytes cost the same ceil(m/128) pieces). Env
    HAP_TPU_PROMOTE_MAX."""
    return int(os.environ.get("HAP_TPU_PROMOTE_MAX", "128"))


def pack_tables(streams: Sequence[bytes],
                expected_lens: Optional[Sequence[int]] = None,
                S_max: Optional[int] = None,
                promote_max: Optional[int] = None) -> PackedTables:
    """Compile a set of streams to fixed-shape tables with the Python
    compiler (the reference's multithreaded C++ compiler is not ported).

    ``S_max`` must equal the S_max the executor will be called with
    (``pack_fields`` bakes the literal row base ceil(S_max/128) into the
    tables); by default it is the largest decoded length."""
    if promote_max is None:
        promote_max = default_promote_max()
    tables = [build_op_table(s, None if expected_lens is None
                             else int(expected_lens[i]), promote_max)
              for i, s in enumerate(streams)]
    good = [t for t in tables if t is not None]
    C = len(streams)
    n_max = max([t.ops.shape[0] for t in good] + [1])
    l_max = max([t.lit.shape[0] for t in good] + [1])
    if S_max is None:
        S_max = max([t.out_len for t in good] + [1])
    nout = -(-S_max // 128)
    ops = np.zeros((C, n_max, 2), np.int32)
    lit = np.zeros((C, l_max), np.uint8)
    n_ops = np.zeros(C, np.int32)
    n_lit = np.zeros(C, np.int32)
    out_len = np.zeros(C, np.int32)
    ok = np.zeros(C, bool)
    for i, t in enumerate(tables):
        if t is None:
            continue
        ok[i] = True
        n_ops[i] = t.ops.shape[0]
        ops[i, : t.ops.shape[0]] = pack_fields(t.ops, nout)
        n_lit[i] = t.lit.shape[0]
        lit[i, : t.lit.shape[0]] = t.lit
        out_len[i] = t.out_len
    return PackedTables(*(torch.from_numpy(a) for a in
                          (ops, n_ops, lit, n_lit, out_len, ok)), S_max=S_max)


def execute_table_host(t: OpTable) -> bytes:
    """Scalar executor of one logical table: the oracle for kernel G.
    Raises ValueError on a table that breaks the piece invariant."""
    out = np.zeros(t.out_len, np.uint8)
    op = 0
    lc = 0
    for w0, off in t.ops:
        m, end, off = int(w0) & 0xFF, int(w0) >> 8, int(off)
        if not (1 <= m <= 128 and (op & 127) + m <= 128
                and end == int((op & 127) + m == 128)):
            raise ValueError(f"bad piece (m={m}, end={end}) at {op}")
        if off == 0:
            out[op:op + m] = t.lit[lc:lc + m]
            lc += m
        else:
            if not m <= off <= op:  # a piece never reads what it writes
                raise ValueError(f"bad copy (m={m}, off={off}) at {op}")
            out[op:op + m] = out[op - off:op - off + m]
        op += m
    if op != t.out_len:
        raise ValueError(f"table writes {op} bytes, not {t.out_len}")
    return out.tobytes()
