"""Snappy LZ encoder planning as dense int32 plane math (torch ops).

A port of the reference's device LZ planner. Match finding runs over each
chunk's 4-byte word lattice at a static set of candidate offsets (block
multiples and the frame's block-row stride), all candidates' match masks
packed into one int32 plane (bit c = candidate c matches here). Per word the
candidate with the longest capped run through it wins; runs under
MIN_RUN_WORDS words are demoted to literals; copy runs steal up to 3
matching bytes from their neighbouring literals. The result is a set of
per-segment piece tables whose records carry every piece's output
position, so emission (kernel A, ``lz_kernels.emit_lz_streams``) has no
serial dependency.

Every field of ``LzPlan`` matches the reference exactly: all of it is
integer arithmetic. torch has no uint32 arithmetic on the CPU, so the
planes are int32 and bit 31 (``KIND_COPY``) is only ever OR-ed in.

The emitted stream is conforming Snappy: varint preamble, 1-3 byte literal
tags, copy-2 elements with 16-bit offsets.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_I32 = torch.int32

SEG_WORDS = 256          # piece-table segment (1024 payload bytes)
SEG_SLOTS = 32           # piece slots per segment
COPY_SPLIT_ELEMS = 128   # max copy-2 elements per piece
COPY_SPLIT_WORDS = COPY_SPLIT_ELEMS * 16  # 2048 words per copy piece
MIN_RUN_WORDS = 4        # demote copy runs under 16 bytes
_FOLD_LIMIT = SEG_SLOTS - 4  # copy-run starts per segment before the
# segment is forced literal (keeps every segment's pieces within SEG_SLOTS)


def candidate_distances(S: int, row_bytes: int, G: int = 16) -> Tuple[int, ...]:
    """Static candidate byte offsets: multiples of 4, < S, <= 65535,
    at most 28, ascending (ties prefer the smaller offset). Block multiples
    1..16, a few coarser multiples, and the block-row stride +-1 block."""
    G = G if G in (8, 16) else 16
    cands = list(range(G, 16 * G + 1, G))
    cands += [20 * G, 24 * G, 32 * G, 48 * G, 64 * G, 128 * G, 256 * G]
    if row_bytes % 4 == 0 and row_bytes > 0:
        cands += [row_bytes - G, row_bytes, row_bytes + G,
                  2 * row_bytes, 3 * row_bytes]
    out = sorted({d for d in cands if 4 <= d < min(S, 65536) and d % 4 == 0})
    if len(out) > 28:
        drop = [14 * G, 11 * G, 13 * G, 7 * G, 19 * G]
        out = [d for d in out if d not in drop][:28]
    return tuple(out)


def lz_bound(S: int) -> int:
    """Worst-case emitted stream width: all-literal with 3-byte tags per
    1024-byte grid piece + varint, rounded up."""
    n_pieces = -(-S // 1024) + 1
    return S + 3 * n_pieces + 8


class LzPlan(NamedTuple):
    """Planning output for one (C, S) chunk batch (int32 tensors).

    Record packing (2 int32 words per piece):
      w0: out_pos (bits 0..19) | len_field << 20 (bits 20..30) | kind << 31
          literal: len_field = byte length (<= 1030); copy: elements (<= 128)
      w1: literal: in_byte_pos (bits 0..19) | tag_len << 20 (2 bits)
          copy:    d_bytes (bits 0..16) | tail_len << 17 (7 bits: the last
                   element's length, 1..64)
    """

    tables_lit: torch.Tensor   # (C, NSEG * SEG_SLOTS, 2)
    tables_copy: torch.Tensor  # (C, NSEG * SEG_SLOTS, 2)
    counts: torch.Tensor       # (C, NSEG, 2) [lit, copy] pieces per segment
    comp_len: torch.Tensor     # (C,) stream bytes, varint included
    n_pieces: torch.Tensor     # (C,) total pieces


KIND_COPY = -(1 << 31)  # int32 bit 31 marks copy pieces


def _varint(S: int) -> np.ndarray:
    out = []
    v = S
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | 0x80 if v else b)
        if not v:
            return np.asarray(out, np.uint8)


def _shl(x: torch.Tensor, k: int) -> torch.Tensor:
    """x shifted toward higher index along dim 1: out[i] = x[i-k], 0-filled."""
    if k == 0:
        return x
    return F.pad(x[:, :-k], (k, 0))


def _shr(x: torch.Tensor, k: int, fill: int = 0) -> torch.Tensor:
    """x shifted toward lower index along dim 1: out[i] = x[i+k], ``fill``
    at the tail."""
    if k == 0:
        return x
    return F.pad(x[:, k:], (0, k), value=fill)


def _or_spread(p: torch.Tensor, l: int) -> torch.Tensor:
    """out[i] = OR of p[i .. i+l-1]."""
    k = 1
    while k < l:
        p = p | _shr(p, k)
        k *= 2
    return p


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=1).values


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """Suffix minimum along dim 1."""
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


def plan_lz(data: torch.Tensor, S: int, G: int, row_bytes: int) -> LzPlan:
    """(C, S) uint8 chunk payloads -> LzPlan. S must be a multiple of 4 and
    < 2**20 (record packing)."""
    if S % 4 or S >= (1 << 20):
        raise ValueError(f"chunk size {S} must be a multiple of 4 below 2**20")
    dev = data.device
    C = data.shape[0]
    N = S // 4
    NSEG = -(-N // SEG_WORDS)
    Np = NSEG * SEG_WORDS
    cands = candidate_distances(S, row_bytes, G)
    P_VAR = len(_varint(S))

    def full(v):
        return torch.full((C, Np), v, dtype=_I32, device=dev)

    words = data.contiguous().view(_I32)  # (C, N) little-endian words
    if Np != N:
        words = F.pad(words, (0, Np - N))
    pos = torch.arange(Np, dtype=_I32, device=dev)[None, :].expand(C, Np)
    in_range = pos < N

    # ---- packed candidate masks + capped-run levels -------------------
    M = full(0)
    for ci, db in enumerate(cands):
        c = db // 4
        eq = F.pad((words[:, c:] == words[:, :-c]).to(_I32), (c, 0))
        M = M | (eq << ci)
    M = torch.where(in_range, M, 0)

    levels = [M]
    k = 1
    while k < 256:  # run cap 256 words
        levels.append(levels[-1] & _shl(levels[-1], k))
        k *= 2

    # ---- run-through coverage + selection ----------------------------
    bits = levels[0]
    sel_lvl = full(1)
    l = 2
    for P in levels[1:]:
        R = _or_spread(P, l)
        nz = R != 0
        bits = torch.where(nz, R, bits)
        sel_lvl = torch.where(nz, l, sel_lvl)
        l *= 2
    low = bits & (-bits)  # smallest candidate index at the best level
    dw = full(0)
    prevsel = full(0)  # words[i - 1 - dw[i]]
    nextsel = full(0)  # words[i + 1 - dw[i]]
    for ci, db in enumerate(cands):
        c = db // 4
        hit = (low >> ci) & 1
        dw = dw + hit * c
        prevsel = prevsel + hit * _shl(words, c + 1)
        nextsel = nextsel + hit * (_shl(words, c - 1) if c > 1 else words)
    dw = torch.where(bits != 0, dw, 0)

    # ---- min-run demotion + overflow fold ----------------------------
    dw = torch.where(sel_lvl < MIN_RUN_WORDS, 0, dw)
    first_col = torch.ones((C, 1), dtype=torch.bool, device=dev)
    bnd = torch.cat([first_col, dw[:, 1:] != dw[:, :-1]], dim=1)
    seg_starts = (bnd & (dw > 0)).to(_I32).reshape(C, NSEG, SEG_WORDS)
    fold = seg_starts.sum(dim=2, dtype=_I32) > _FOLD_LIMIT
    dw = torch.where(fold.repeat_interleave(SEG_WORDS, dim=1), 0, dw)

    # ---- final run structure -----------------------------------------
    b = torch.cat([first_col, dw[:, 1:] != dw[:, :-1]], dim=1)
    rs = _cummax(torch.where(b, pos, -1))
    re = _shr(_rev_cummin(torch.where(b, pos, Np)), 1, fill=Np)
    re = torch.clamp(re, max=N)
    is_copy = dw > 0
    is_lit = ~is_copy
    is_start = pos == rs
    copy_start = is_start & is_copy
    run_words = re - rs

    # ---- byte-edge extension -----------------------------------------
    def _bytes4(w):
        return [(w >> (8 * k)) & 0xFF for k in range(4)]

    def _eq_bytes(a, b_):
        return [(x == y).to(_I32) for x, y in zip(_bytes4(a), _bytes4(b_))]

    e = _eq_bytes(_shl(words, 1), prevsel)
    ext_l_raw = e[3] * (1 + e[2] * (1 + e[1]))  # trailing bytes, 0..3
    e = _eq_bytes(_shr(words, 1), nextsel)
    ext_r_raw = e[0] * (1 + e[1] * (1 + e[2]))  # leading bytes, 0..3

    is_last = (pos == re - 1) & is_copy
    prev_is_lit = _shl(is_lit.to(_I32), 1) != 0
    next_is_lit = _shr(is_lit.to(_I32), 1) != 0
    ext_l_s = torch.where(copy_start & prev_is_lit & (pos > dw), ext_l_raw, 0)
    ext_r_e = torch.where(
        is_last & next_is_lit & (pos < N - 1) & (pos + 1 > dw), ext_r_raw, 0)

    # the left copy's ext_r carried forward across the literal run
    er_prop_packed = _cummax(torch.where(is_last, (pos << 2) | ext_r_e, -1))
    has_er = er_prop_packed >= 0
    er_prop = torch.where(has_er, er_prop_packed & 3, 0)
    er_prop_pos = torch.where(has_er, er_prop_packed >> 2, -1)
    lit_start = is_start & is_lit
    er_head = torch.where(lit_start & (er_prop_pos == pos - 1), er_prop, 0)
    eh_packed = _cummax(torch.where(lit_start, (pos << 2) | er_head, -1))
    eh_at = torch.where(eh_packed >= 0, eh_packed & 3, 0)
    prev_lit_words = _shl(pos - rs, 1) + 1
    prev_lit_bytes = 4 * prev_lit_words - _shl(eh_at, 1)
    ext_l = torch.minimum(ext_l_s, torch.clamp(prev_lit_bytes, min=0))
    ext_l = torch.where(copy_start, ext_l, 0)

    BIGP = (Np + 1) << 2
    er_back = _rev_cummin(torch.where(is_last, (pos << 2) | ext_r_e, BIGP))
    er_run = torch.where((er_back >> 2) == re - 1, er_back & 3, 0)
    el_fwd = _cummax(torch.where(copy_start, (pos << 2) | ext_l, -1))
    el_run = torch.where(el_fwd >= 0, torch.where(
        (el_fwd >> 2) == rs, el_fwd & 3, 0), 0)

    lit_last = (pos == re - 1) & is_lit
    el_next_packed = _rev_cummin(
        torch.where(copy_start, (pos << 2) | ext_l, Np << 2))
    el_next = torch.where((el_next_packed >> 2) == re, el_next_packed & 3, 0)
    steal_head = torch.where(lit_start, er_head, 0)
    steal_tail = torch.where(lit_last, el_next, 0)
    lit_bytes = torch.where(
        is_lit & in_range,
        torch.clamp(4 - steal_head - steal_tail, min=0), 0)

    # ---- emission sizing + stream positions ---------------------------
    L_run = 4 * run_words + el_run + er_run  # copy run bytes incl. ext
    nel_total = -((-L_run) // 64)
    grid_lit_start = (is_lit & (pos % SEG_WORDS == 0) & (~is_start)
                      & in_range)
    lit_piece_start = (is_start & is_lit & in_range) | grid_lit_start
    grid_end = (pos // SEG_WORDS + 1) * SEG_WORDS
    pend = torch.clamp(torch.minimum(grid_end, re), max=N)
    blen = torch.where(
        lit_piece_start,
        4 * (pend - pos)
        - torch.where(is_start, steal_head, 0)
        - torch.where(pend == re, el_next, 0),
        0)
    lit_piece_start = lit_piece_start & (blen > 0)
    tag_len = torch.where(blen > 256, 3,
                          torch.where(blen > 60, 2, 1)).to(_I32)
    tag_len = torch.where(lit_piece_start, tag_len, 0)

    contrib = torch.where(is_copy,
                          torch.where(copy_start, 3 * nel_total, 0),
                          lit_bytes + tag_len)
    cs_inc = torch.cumsum(contrib, dim=1, dtype=_I32)
    out_cs = P_VAR + cs_inc - contrib
    comp_len = P_VAR + cs_inc[:, -1]

    # ---- piece records -----------------------------------------------
    anchor = is_copy & ((pos - rs) % COPY_SPLIT_WORDS == 0) & in_range
    j_idx = (pos - rs) // COPY_SPLIT_WORDS
    nel_before = COPY_SPLIT_ELEMS * j_idx
    nel_piece = torch.clamp(nel_total - nel_before, max=COPY_SPLIT_ELEMS)
    copy_piece = anchor & (nel_piece > 0)
    is_final_piece = nel_before + nel_piece == nel_total
    tail_len = torch.where(is_final_piece, L_run - 64 * (nel_total - 1), 64)
    copy_out = (out_cs - torch.where(copy_start, 0, 3 * nel_total)
                + 3 * nel_before)
    lit_in = 4 * pos + torch.where(is_start, steal_head, 0)

    def _rank_select(mask, w0, w1):
        """Per-segment rank-select of masked records into SEG_SLOTS slots
        (a record ranked past the last slot is dropped; counts keep it)."""
        pseg = mask.to(_I32).reshape(C, NSEG, SEG_WORDS)
        rank = torch.cumsum(pseg, dim=2, dtype=_I32) - pseg
        counts = pseg.sum(dim=2, dtype=_I32)
        seg = torch.arange(NSEG, dtype=_I32, device=dev)[None, :, None]
        keep = (pseg > 0) & (rank < SEG_SLOTS)
        dump = NSEG * SEG_SLOTS
        slot = torch.where(keep, seg * SEG_SLOTS + rank, dump)
        slot = slot.reshape(C, Np).to(torch.int64)
        table = torch.zeros((C, dump + 1, 2), dtype=_I32, device=dev)
        idx = slot[:, :, None].expand(C, Np, 2)
        table.scatter_(1, idx, torch.stack([w0, w1], dim=2))
        return table[:, :dump].contiguous(), counts

    lit_w0 = out_cs | (blen << 20)
    lit_w1 = lit_in | (tag_len << 20)
    cp_w0 = copy_out | (nel_piece << 20) | KIND_COPY
    cp_w1 = (4 * dw) | (tail_len << 17)
    tables_lit, counts_lit = _rank_select(lit_piece_start, lit_w0, lit_w1)
    tables_copy, counts_copy = _rank_select(copy_piece, cp_w0, cp_w1)
    counts = torch.stack([counts_lit, counts_copy], dim=2)
    n_pieces = (counts_lit + counts_copy).sum(dim=1, dtype=_I32)
    return LzPlan(tables_lit, tables_copy, counts, comp_len, n_pieces)


# ---------------------------------------------------------------------------
# Reference emitter: the plain version of kernel A
# ---------------------------------------------------------------------------

def emit_reference(data: torch.Tensor, plan: LzPlan, S: int) -> torch.Tensor:
    """Replay each chunk's piece tables into its Snappy stream (host loop).

    Returns (C, lz_bound(S)) uint8 on the CPU: the varint preamble, every
    piece at its recorded position, and zeros past the pieces. This is
    the bit-exact contract of the CUDA emission kernel."""
    data_np = data.cpu().numpy()
    t_lit = plan.tables_lit.cpu().numpy()
    t_copy = plan.tables_copy.cpu().numpy()
    counts = plan.counts.cpu().numpy()
    C = data_np.shape[0]
    NSEG = counts.shape[1]
    pre = _varint(S)
    out = np.zeros((C, lz_bound(S)), np.uint8)
    for c in range(C):
        buf = out[c]
        buf[: len(pre)] = pre
        for s in range(NSEG):
            for k in range(int(counts[c, s, 1])):  # copy pieces
                w0, w1 = (int(x) for x in t_copy[c, s * SEG_SLOTS + k])
                o = w0 & 0xFFFFF
                nel = (w0 >> 20) & 0x7FF
                d = w1 & 0x1FFFF
                tail = (w1 >> 17) & 0x7F
                el = np.empty((nel, 3), np.uint8)
                el[:, 0] = 2 | (63 << 2)
                el[-1, 0] = 2 | ((tail - 1) << 2)
                el[:, 1] = d & 0xFF
                el[:, 2] = d >> 8
                buf[o : o + 3 * nel] = el.reshape(-1)
            for k in range(int(counts[c, s, 0])):  # literal pieces
                w0, w1 = (int(x) for x in t_lit[c, s * SEG_SLOTS + k])
                o = w0 & 0xFFFFF
                blen = (w0 >> 20) & 0x7FF
                tl = (w1 >> 20) & 3
                ip = w1 & 0xFFFFF
                n = blen - 1
                if tl == 1:
                    buf[o] = n << 2
                elif tl == 2:
                    buf[o : o + 2] = (60 << 2, n)
                else:
                    buf[o : o + 3] = (61 << 2, n & 0xFF, n >> 8)
                buf[o + tl : o + tl + blen] = data_np[c, ip : ip + blen]
    return torch.from_numpy(out)
