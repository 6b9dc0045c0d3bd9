"""The PyTorch/CUDA port (hap_tpu_torch) against the JAX reference, on the CPU.

Every module of the port that holds a kernel, and the Hap Q + LZ main path
as a whole, is held against the JAX package on the same inputs (made from
seeds with numpy):

* layout and scaled YCoCg: exact at 1x1, 5x3, 17x33, 37x53 and 64x64;
* BC4 encode and BC4/BC1 decode: exact; BC1 encode (float32 least-squares
  refit): at most 1% of blocks differ (tie blocks), quality within 0.05 dB;
* the LZ planner: every LzPlan field exact; kernel A's plain version
  byte-identical to the reference emitter; kernels B-D's plain versions
  against numpy and hand-corrupted streams;
* frames: byte-identical to the reference's host serializer around the
  same streams; the decoder fuzzed as the reference's device decoder is;
* the slice: the reference's own main path (encode_pipeline and
  decode_pipeline, Pallas kernels in interpret mode) runs once on a 64x128
  frame; the port rebuilds its frame bytes from its words, decodes its
  frame bit-exactly, and encodes the pixels to the same BC4 words;
* the RLE profile (HAP_TPU_DEVICE_LZ=0): unit sizes, streams and lengths
  byte-identical to the reference's XLA encoder, and kernels D + D(ii)'s
  plain decode equal to its XLA decoder in bytes and ok flags, on flat,
  random, mixed and broken-periodic payloads at S in {16, 2048, 4096,
  8192, 12960}, on corrupted and on LZ-profile streams; RLE frames
  byte-identical to the host serializer, the RLE decoder fuzzed, and the
  slice under RLE around the reference's words; DeviceSession under both
  profiles (stats against the host parse and the reference's
  EncodeStats, reasons for corrupted frames);
* the foreign-frame path: the port's Snappy compressor byte-identical to
  the reference's; its op tables equal the reference compiler's field by
  field; kernel G's plain version on the reference's own tables equals
  the reference's scalar executor, and kernel F's equals the reference's
  pure-Python decoder in bytes and verdict, on hand-made, corrupt and
  fuzzed streams; encoder frames and non-uniform foreign frames (offset
  table, shuffled storage, uneven and mixed raw/Snappy chunks) decode on
  both routes and through ForeignGopSession to exactly the pixels of the
  reference's host decode (codecs.decode_frame).

The CUDA kernels themselves are held against these plain versions on the
GPU by ``chip_smoke.py``.

All of it is THREE tests. The full suite runs under pytest-xdist, whose load
scheduler sizes its batches from the number of collected tests; every
test this file adds reshuffles which worker runs which JAX test. In this
repository's suite that is not neutral: long-lived workers accumulate the
memory mappings of every XLA executable they compile, and a schedule that
piles more compiles onto one worker drives it into the process's map
limit and kills it inside an XLA compile. Few tests move the schedule
little. torch and the port are imported inside the tests, so a worker
that never runs them never loads torch.
"""

import contextlib
import os
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hap_tpu.constants import Compressor, HapError as RefHapError, TextureFormat
from hap_tpu.container.parse import parse_frame as ref_parse_frame
from hap_tpu.container.plan import legalize_chunk_count as ref_legalize
from hap_tpu.container.serialize import serialize_texture
from hap_tpu.kernels import bc1 as j1
from hap_tpu.kernels import bc4 as j4
from hap_tpu.kernels import layout as jl
from hap_tpu.kernels import ycocg as jy
from hap_tpu.pipeline import any_frame as jany
from hap_tpu.pipeline import codecs as jcodecs
from hap_tpu.pipeline import device_pipeline as jpipe
from hap_tpu.pipeline import session as jsession
from hap_tpu.snappy import device as jdev
from hap_tpu.snappy import device_lz as jlz
from hap_tpu.snappy import optable as ref_optable
from hap_tpu.snappy import pyref as ref_pyref
from tools import bench_content

G = 16  # Hap Q block bytes


def _load_port():
    """Import torch and the port into this module's globals."""
    import torch
    from hap_tpu_torch.constants import (
        FORMAT_YCOCG_DXT5, HapError, legalize_chunk_count)
    from hap_tpu_torch.container.parse import parse_frame
    from hap_tpu_torch.content import make_frame, make_gop
    from hap_tpu_torch.kernels import bc1 as t1
    from hap_tpu_torch.kernels import bc4 as t4
    from hap_tpu_torch.kernels import layout as tl
    from hap_tpu_torch.kernels import ycocg as ty
    from hap_tpu_torch.pipeline.device_frame import (
        _encode_chunks, decode_frame_device, encode_frame_device,
        frame_layout)
    from hap_tpu_torch.pipeline.device_pipeline import (
        decode_pipeline, encode_blocks, encode_pipeline,
        encode_pipeline_stats, encode_words, roundtrip_pipeline)
    from hap_tpu_torch.pipeline.session import DECODE_REASONS, DeviceSession
    from hap_tpu_torch.pipeline.any_frame import (
        ForeignGopSession, decode_frame_any, decode_frame_any_device)
    from hap_tpu_torch.reference_state import (
        encode_settings, lz_plan_from_numpy, packed_tables_from_numpy,
        words_from_numpy)
    from hap_tpu_torch.snappy import device as tdev
    from hap_tpu_torch.snappy import device_lz as tlz
    from hap_tpu_torch.snappy import optable
    from hap_tpu_torch.snappy import pyref
    from hap_tpu_torch.snappy.exec_kernels import (
        EXEC_TABLES, execute_op_tables)
    from hap_tpu_torch.snappy.general_kernels import (
        GENERAL_DECODE, decode_any_streams)
    from hap_tpu_torch.snappy.lz_kernels import (
        LZ_DECODE, LZ_EMIT, decode_lz_streams_from_frame, emit_lz_streams)
    from hap_tpu_torch.snappy.rle_kernels import (
        RLE_COMPACT, RLE_DECODE, compact_streams_from_data)
    from hap_tpu_torch.snappy.stream_kernels import (
        RAW_CHUNKS, STITCH, raw_chunks_from_frame, stitch_streams)
    torch.set_num_threads(1)
    globals().update(locals())


def _i32(a):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    return 10 * np.log10(255.0 ** 2 / max(np.mean(d * d), 1e-12))


def _rand_img(seed, h, w, c=3):
    shape = (h, w, c) if c else (h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# layout, scaled YCoCg, BC4, BC1
# ---------------------------------------------------------------------------

SHAPES = [(1, 1), (5, 3), (17, 33), (37, 53), (64, 64)]


def _reference_texture_plane(img, h, w):
    @jax.jit
    def f(x):
        planes = jl.image_to_block_planes(x)
        cocgs, y = jy.rgb_to_cocgs_y_planes(planes)
        rgb = jy.cocgs_y_to_rgb_planes_f32(cocgs, y)
        blocks = jl.image_to_blocks(x)
        y0, y1 = j4.bc4_encode_planes_words(y)
        return (planes, cocgs, y, rgb, blocks,
                jl.blocks_to_image(blocks, h, w),
                jl.block_planes_to_image(rgb.astype(jnp.uint8), h, w),
                y0, y1, j4.bc4_decode_planes(y0, y1))
    return [np.asarray(a) for a in f(jnp.asarray(img))]


def _check_layout_ycocg_bc4(h, w):
    img = _rand_img(h * 1000 + w, h, w)
    (planes, cocgs, y, rgb, blocks, b2i, p2i, y0, y1,
     y_dec) = _reference_texture_plane(img, h, w)
    x = torch.from_numpy(img)
    tp = tl.image_to_block_planes(x)
    tc, tyy = ty.rgb_to_cocgs_y_planes(tp)
    trgb = ty.cocgs_y_to_rgb_planes_f32(tc, tyy)
    tb = tl.image_to_blocks(x)
    np.testing.assert_array_equal(tp.numpy(), planes)
    np.testing.assert_array_equal(tc.numpy(), cocgs)
    np.testing.assert_array_equal(tyy.numpy(), y)
    np.testing.assert_array_equal(trgb.numpy(), rgb)
    np.testing.assert_array_equal(
        ty.cocgs_y_to_rgb_planes(tc, tyy).numpy(), rgb.astype(np.uint8))
    np.testing.assert_array_equal(tb.numpy(), blocks)
    np.testing.assert_array_equal(tl.blocks_to_image(tb, h, w).numpy(), b2i)
    np.testing.assert_array_equal(
        tl.block_planes_to_image(trgb.to(torch.uint8), h, w).numpy(), p2i)
    np.testing.assert_array_equal(tl.block_planes_to_image(tp, h, w).numpy(),
                                  img)
    m0, m1 = t4.bc4_encode_planes_words(tyy)
    np.testing.assert_array_equal(_u32(m0), y0)
    np.testing.assert_array_equal(_u32(m1), y1)
    np.testing.assert_array_equal(
        t4.bc4_decode_planes(_i32(y0), _i32(y1)).numpy(), y_dec)


def _check_single_channel_planes():
    img = _rand_img(5, 9, 7, c=0)
    ref = np.asarray(jl.image_to_block_planes(jnp.asarray(img)))
    tp = tl.image_to_block_planes(torch.from_numpy(img))
    np.testing.assert_array_equal(tp.numpy(), ref)
    np.testing.assert_array_equal(tl.block_planes_to_image(tp, 9, 7).numpy(),
                                  img)
    assert tl.padded_dims(9, 7) == jl.padded_dims(9, 7) == (12, 8)


def _check_word_interleave(k, n):
    rng = np.random.default_rng(k * n)
    ws = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(k)]
    ref = np.asarray(jl.interleave_words_mxu(tuple(jnp.asarray(w) for w in ws)))
    mine = tl.interleave_words([_i32(w) for w in ws])
    np.testing.assert_array_equal(_u32(mine), ref)
    for w, b in zip(ws, tl.deinterleave_words(mine, k)):
        np.testing.assert_array_equal(_u32(b), w)


def _check_payload_views():
    words = np.array([0x04030201, 0xF0E0D0C0], np.uint32)
    pay = tl.words_to_payload(_i32(words))
    assert pay.numpy().tobytes() == words.astype("<u4").tobytes()
    np.testing.assert_array_equal(_u32(tl.payload_to_words(pay)), words)
    with pytest.raises(ValueError):
        tl.payload_to_words(torch.zeros(6, dtype=torch.uint8))


def _check_decoders_on_random_words():
    """Arbitrary words exercise BC4's 6-interp mode (a0 <= a1) and BC1's
    3-colour punch-through mode (c0 <= c1)."""
    rng = np.random.default_rng(11)
    w0, w1 = (rng.integers(0, 2**32, 4096, dtype=np.uint32) for _ in range(2))

    @jax.jit
    def ref(w0, w1):
        return (j4.bc4_decode_planes(w0, w1),
                j1.bc1_decode_planes(w0, w1, True),
                j1.bc1_decode_planes(w0, w1, False))

    bc4_ref, *bc1_refs = ref(jnp.asarray(w0), jnp.asarray(w1))
    np.testing.assert_array_equal(
        t4.bc4_decode_planes(_i32(w0), _i32(w1)).numpy(), np.asarray(bc4_ref))
    for punch, (jrgb, jop) in zip((True, False), bc1_refs):
        rgb, opaque = t1.bc1_decode_planes(_i32(w0), _i32(w1), punch)
        np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
        np.testing.assert_array_equal(opaque.numpy(), np.asarray(jop))


def _check_bc1_encode_parity():
    imgs = [make_frame(c, 1, 64, 64) for c in ("natural", "graphics", "noise")]
    imgs.append(_rand_img(2, 64, 64))
    ref = jax.jit(lambda c: j1.bc1_encode_planes_words(c, 2, False))
    mismatch = total = 0
    for img in imgs:
        cocgs, _ = ty.rgb_to_cocgs_y_planes(
            tl.image_to_block_planes(torch.from_numpy(img)))
        c0, c1 = (np.asarray(a) for a in ref(jnp.asarray(cocgs.numpy())))
        c_ref, _ = t1.bc1_decode_planes(_i32(c0), _i32(c1), False)
        m0, m1 = t1.bc1_encode_planes_words(cocgs, refine_iters=2)
        diff = (_u32(m0) != c0) | (_u32(m1) != c1)
        mismatch += int(diff.sum())
        total += diff.size
        rgb, _ = t1.bc1_decode_planes(m0, m1, dxt1_punchthrough=False)
        src = cocgs.numpy()
        assert abs(_psnr(rgb.numpy(), src) - _psnr(c_ref.numpy(), src)) <= 0.05
    assert mismatch <= 0.01 * total, (mismatch, total)
    with pytest.raises(NotImplementedError):  # effort="best" is not ported
        t4.bc4_encode_planes_words(torch.zeros((16, 4)), candidates=True)
    with pytest.raises(NotImplementedError):
        t1.bc1_encode_planes_words(torch.zeros((3, 16, 4)), candidates=True)


# ---------------------------------------------------------------------------
# LZ planner and the plain versions of kernels A-D
# ---------------------------------------------------------------------------

LZ_S = 4608  # 1152 words: the last 256-word segment is padded
LZ_ROW = 16 * 288 // 4


def _payload_rows(rng):
    rows = [np.full(LZ_S, 0xAB, np.uint8),
            np.tile(rng.integers(0, 256, 16, dtype=np.uint8), LZ_S // 16),
            rng.integers(0, 256, LZ_S, dtype=np.uint8)]
    mixed = np.tile(rng.integers(0, 256, 48, dtype=np.uint8),
                    LZ_S // 48 + 1)[:LZ_S]
    mixed[LZ_S // 2:] = rng.integers(0, 256, LZ_S - LZ_S // 2)
    rows.append(mixed)
    for cls in ("natural", "graphics"):  # real DXT payloads
        img = torch.from_numpy(make_frame(cls, 2, 32, 288))
        rows.append(tl.words_to_payload(encode_blocks(img)).numpy()[:LZ_S])
    return np.stack(rows)


@pytest.fixture(scope="module")
def reference_plan():
    """The JAX planner, jitted once over every content kind (with clean
    JAX caches around it, as the main-path fixture)."""
    jax.clear_caches()
    _load_port()
    data = _payload_rows(np.random.default_rng(3))
    ref = jax.jit(jlz.plan_lz, static_argnums=(1, 2, 3))(
        jnp.asarray(data), LZ_S, 16, LZ_ROW)
    ref = [np.asarray(a) for a in ref]
    jax.clear_caches()
    return data, ref


def _check_plan_and_emission(data, ref):
    plan = tlz.plan_lz(torch.from_numpy(data), LZ_S, 16, LZ_ROW)
    for name, a, b in zip(jlz.LzPlan._fields, ref, plan):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert int(plan.counts.max()) <= tlz.SEG_SLOTS
    streams = jlz.emit_reference(data, jlz.LzPlan(*ref), LZ_S)
    emitted = emit_lz_streams(torch.from_numpy(data), plan, LZ_S).numpy()
    assert emitted.shape == (len(data), tlz.lz_bound(LZ_S))
    for c, st in enumerate(streams):
        assert emitted[c, :len(st)].tobytes() == st
        assert not emitted[c, len(st):].any()
        assert ref_pyref.decompress(st, LZ_S) == data[c].tobytes()


def _check_static_planning_facts():
    for S, row_bytes, g in ((4096, 256, 8), (129600, 15360, 16), (64, 0, 16)):
        assert tlz.candidate_distances(S, row_bytes, g) == \
            jlz.candidate_distances(S, row_bytes, g)
        assert tlz.lz_bound(S) == jlz.lz_bound(S)
        np.testing.assert_array_equal(tlz._varint(S), jlz._varint(S))


def _streams(data):
    S = data.shape[1]
    plan = tlz.plan_lz(torch.from_numpy(data), S, 16, 256)
    comp = emit_lz_streams(torch.from_numpy(data), plan, S)
    return [comp[c, :int(plan.comp_len[c])].numpy().tobytes()
            for c in range(len(data))]


def _lz_decode(streams, S, is_comp=None):
    """Streams back to back in one buffer through kernel C's plain version."""
    pos = np.cumsum([0] + [len(s) for s in streams[:-1]]).astype(np.int32)
    frame = np.frombuffer(b"".join(streams) + bytes(64), np.uint8).copy()
    sizes = np.array([len(s) for s in streams], np.int32)
    C = len(streams)
    cis = torch.ones(C, dtype=torch.bool) if is_comp is None else is_comp
    out = torch.zeros((C, S), dtype=torch.uint8)
    ok = torch.zeros(C, dtype=torch.bool)
    decode_lz_streams_from_frame(torch.from_numpy(frame), torch.from_numpy(pos),
                                 torch.from_numpy(sizes), cis, S, out, ok)
    return out.numpy(), ok.numpy()


def _check_lz_decode_roundtrip():
    data = _payload_rows(np.random.default_rng(4))[:, :4096]
    streams = _streams(data)
    for c, st in enumerate(streams):
        assert ref_pyref.decompress(st, 4096) == data[c].tobytes()
    out, ok = _lz_decode(streams, 4096)
    assert ok.all()
    np.testing.assert_array_equal(out, data)


def _check_lz_decode_rejects_out_of_profile_streams():
    S = 2048
    rng = np.random.default_rng(5)
    data = np.tile(rng.integers(0, 256, 6, dtype=np.uint8), S // 6 + 1)[:S]
    copy1 = ref_pyref.compress(data.tobytes())  # short offsets -> copy-1
    assert any(b & 3 == 1 for b in copy1[2:])
    lit64 = bytes([60 << 2, 63]) + bytes(range(64))
    good = bytes([0x80, 0x10]) + lit64 + \
        bytes([2 | (63 << 2), 64, 0]) * 31  # literal 64 + 31 copy-2 d=64
    cases = {
        "copy-1": copy1,
        "offset < 8": bytes([0x80, 0x10, 7 << 2]) + bytes(8)
        + bytes([2 | (63 << 2), 4, 0]) * 32,
        "bad preamble": bytes([0x81, 0x10]) + good[2:],
        "4-byte literal length": bytes([0x80, 0x10, 63 << 2, 0xFF, 7, 0, 0])
        + bytes(S),
        "copy-4": bytes([0x80, 0x10]) + lit64
        + bytes([3 | (63 << 2), 64, 0, 0, 0]) * 31,
        "offset past output": bytes([0x80, 0x10, 7 << 2]) + bytes(8)
        + bytes([2 | (63 << 2), 16, 0]) * 32,
        "truncated": good[:-2],
        "trailing bytes": good + bytes([0]),
        "short output": good[:-3],
    }
    out, ok = _lz_decode([good] + list(cases.values()), S)
    assert ok[0]
    np.testing.assert_array_equal(out[0], np.tile(np.arange(64), 32))
    assert ref_pyref.decompress(good, S) == out[0].tobytes()
    assert not ok[1:].any(), dict(zip(cases, ok[1:]))

    # raw chunks are left to kernel D: row untouched, ok untouched
    data = np.random.default_rng(6).integers(0, 256, (2, 1024), dtype=np.uint8)
    streams = [_streams(data)[0], b"\x00" * 5]
    out, ok = _lz_decode(streams, 1024, torch.tensor([True, False]))
    assert ok[0] and not ok[1]
    np.testing.assert_array_equal(out[0], data[0])
    assert not out[1].any()


def _check_stitch():
    rng = np.random.default_rng(7)
    C, B, S = 5, 40, 32
    comp = torch.from_numpy(rng.integers(1, 256, (C, B), dtype=np.uint8))
    chunks = torch.from_numpy(rng.integers(1, 256, (C, S), dtype=np.uint8))
    src_comp = torch.tensor([True, False, True, True, False])
    lengths = torch.tensor([7, S, 40, 1, S], dtype=torch.int32)
    header = torch.from_numpy(rng.integers(1, 256, 12, dtype=np.uint8))
    q = (12 + torch.cumsum(lengths, 0) - lengths).to(torch.int32)
    frame = stitch_streams(header, torch.tensor(12, dtype=torch.int32), comp,
                           chunks, src_comp, q, lengths, 200).numpy()
    want = np.concatenate([header.numpy()] + [
        (comp if bool(src_comp[c]) else chunks)[c, :int(lengths[c])].numpy()
        for c in range(C)])
    np.testing.assert_array_equal(frame[:len(want)], want)
    assert not frame[len(want):].any() and frame.shape == (200,)


def _check_raw_chunks():
    S = 64
    frame = torch.from_numpy(
        np.random.default_rng(8).integers(0, 256, 300, dtype=np.uint8))
    pos = torch.tensor([10, 74, 250, 200], dtype=torch.int32)
    csizes = torch.tensor([S, S - 1, S, 17], dtype=torch.int32)
    is_comp = torch.tensor([False, False, False, True])
    out, ok = raw_chunks_from_frame(frame, pos, csizes, is_comp, S)
    f = frame.numpy()
    np.testing.assert_array_equal(out[0].numpy(), f[10:74])
    np.testing.assert_array_equal(out[1].numpy(), f[74:138])
    np.testing.assert_array_equal(out[2].numpy()[:50], f[250:])
    assert not out[2].numpy()[50:].any()  # past the frame reads as 0
    assert ok.tolist() == [True, False, True, True]


# ---------------------------------------------------------------------------
# the RLE profile (HAP_TPU_DEVICE_LZ=0): kernels E and D(ii)
# ---------------------------------------------------------------------------

RLE_SIZES = (16, 2048, 4096, 8192, 12960)


@contextlib.contextmanager
def _device_lz(value):
    """HAP_TPU_DEVICE_LZ set around port calls only: the reference reads it
    while tracing, so no JAX function may trace inside."""
    old = os.environ.get("HAP_TPU_DEVICE_LZ")
    os.environ["HAP_TPU_DEVICE_LZ"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["HAP_TPU_DEVICE_LZ"]
        else:
            os.environ["HAP_TPU_DEVICE_LZ"] = old


def _rle_payloads(S, rng):
    """flat, random, mixed (flat then random) and periodic with a literal
    unit in the middle whose last G bytes let the next unit copy them."""
    pat = rng.integers(0, 256, G, dtype=np.uint8)
    flat = np.tile(pat, S // G)
    mixed = flat.copy()
    mixed[S // 2:] = rng.integers(0, 256, S - S // 2)
    broken = flat.copy()
    k = 4096 if S >= 3 * 4096 else 0  # unit 1, or the first G bytes
    broken[k: k + max(G, min(S, 4096) - G)] = rng.integers(
        0, 256, max(G, min(S, 4096) - G))
    return np.stack([flat, rng.integers(0, 256, S, dtype=np.uint8), mixed,
                     broken])


def _reference_rle(data, S):
    """The reference's XLA RLE encoder: (streams, lengths, unit sizes)."""
    (streams, lens), sizes = jax.jit(
        lambda d: (jdev.snappy_encode_chunks(d, S, G, "xla"),
                   jdev._unit_sizes(d, S, G)))(jnp.asarray(data))
    return np.asarray(streams), np.asarray(lens), np.asarray(sizes)


def _rle_corruptions(streams, lens, S):
    """Corrupted copies of the flat row's stream (seeded unit 0, then
    copies, or a seeded/copy tail): (name, stream row, length)."""
    P = len(tdev.profile(S, G).pre)
    flat, n = streams[0], int(lens[0])
    out = []

    def bad(name, at=None, xor=0, dn=0):
        row = flat.copy()
        if at is not None:
            row[at] ^= xor
        out.append((name, row, n + dn))

    bad("preamble", 0, 1)
    if S > G:
        bad("seed tag", P, 4)
        bad("seed pattern", P + 1 + G + 1, 1)
    if S >= 8192:
        seed = tdev.profile(S, G).seed_size
        bad("copy tag", P + seed, 8)
        bad("copy pattern", P + seed + 4, 1)
    bad("length + 1", dn=1)
    bad("length - 1", dn=-1)
    return out


def _check_rle_profile_against_reference():
    """The port's _unit_sizes, snappy_encode_chunks (kernel E's plain
    version) and snappy_decode_chunks (kernels D and D(ii)'s plain
    versions) against the reference's XLA functions at every RLE_SIZES."""
    dec_ref = jax.jit(jdev.snappy_decode_chunks, static_argnums=(2, 3, 4))
    for S in RLE_SIZES:
        data = _rle_payloads(S, np.random.default_rng(S))
        streams, lens, sizes = _reference_rle(data, S)
        x = torch.from_numpy(data)
        np.testing.assert_array_equal(tdev._unit_sizes(x, S, G).numpy(),
                                      sizes)
        mine, mine_len = tdev.snappy_encode_chunks(x, S, G)
        np.testing.assert_array_equal(mine_len.numpy(), lens)
        np.testing.assert_array_equal(mine.numpy(), streams)
        for c in range(len(data)):
            assert ref_pyref.decompress(
                streams[c, :lens[c]].tobytes(), S) == data[c].tobytes()
        emit, esize = tdev._build_emissions(x, S, G)
        np.testing.assert_array_equal(esize.numpy(), sizes)
        rows = list(zip(streams, lens))
        bad = _rle_corruptions(streams, lens, S)
        rows += [(r, n) for _, r, n in bad]
        if S % 4096 == 0:  # the LZ profile's streams are outside this one
            rows += [(np.frombuffer(st, np.uint8), len(st))
                     for st in _streams(data)]
        B = max(len(r) for r, _ in rows)
        comp = np.zeros((len(rows), B), np.uint8)
        for i, (r, _) in enumerate(rows):
            comp[i, :len(r)] = r
        clen = np.array([n for _, n in rows], np.int32)
        out, ok = tdev.snappy_decode_chunks(torch.from_numpy(comp),
                                            torch.from_numpy(clen), S, G)
        ref_out, ref_ok = (np.asarray(a) for a in dec_ref(
            jnp.asarray(comp), jnp.asarray(clen), S, G, "xla"))
        np.testing.assert_array_equal(ok.numpy(), ref_ok)
        n_bad = len(data) + len(bad)
        assert ok[:len(data)].all() and not ok[len(data): n_bad].any(), S
        # LZ streams: a flat chunk's can happen to be this profile's too
        assert S % 4096 or not ok[n_bad:].all()
        np.testing.assert_array_equal(out.numpy()[:len(data)], data)
        np.testing.assert_array_equal(out.numpy()[ok.numpy()],
                                      ref_out[ref_ok])
        assert not out.numpy()[~ok.numpy()].any()  # rejected rows are 0
    # kernel E's plain version takes the flavor from the size alone
    S = 12960
    data = _rle_payloads(S, np.random.default_rng(1))
    sizes = tdev._unit_sizes(torch.from_numpy(data), S, G)
    pos, _ = tdev._positions(sizes, 2)
    out = compact_streams_from_data(torch.from_numpy(data), pos, sizes, S, G,
                                    tdev.profile(S, G).bound).numpy()
    assert not out[:, :2].any()
    lit = sizes == tdev.profile(S, G).emit_max
    assert lit.any() and (~lit).any()


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def _serializer_payload(kind, nbytes, rng):
    if kind == "flat":
        return np.tile(rng.integers(0, 256, G, dtype=np.uint8), nbytes // G)
    if kind == "random":
        return rng.integers(0, 256, nbytes, dtype=np.uint8)
    out = np.empty(nbytes, np.uint8)  # mixed: per-chunk raw fallbacks
    half = nbytes // 2
    out[:half] = np.tile(rng.integers(0, 256, G, dtype=np.uint8),
                         half // G + 1)[:half]
    out[half:] = rng.integers(0, 256, nbytes - half, dtype=np.uint8)
    return out


def _check_frame_bytes_match_host_serializer(kind, chunks):
    payload = _serializer_payload(kind, 1024 * G,
                                  np.random.default_rng(len(kind)))
    S = len(payload) // chunks
    comp, comp_len = _encode_chunks(
        torch.from_numpy(payload).reshape(chunks, S), S, G, 0)
    streams = [comp[c, :int(comp_len[c])].numpy().tobytes()
               for c in range(chunks)]
    host = serialize_texture(payload.tobytes(), TextureFormat.YCoCg_DXT5,
                             Compressor.SNAPPY, chunks, precompressed=streams)
    frame, flen = encode_frame_device(torch.from_numpy(payload), chunks,
                                      FORMAT_YCOCG_DXT5, G)
    fb = frame.numpy()
    assert fb.shape == (frame_layout(len(payload), chunks, G)[-1],)
    assert int(flen) == len(host)
    assert fb[: int(flen)].tobytes() == host
    assert not fb[int(flen):].any()


def _host_payload(fb: bytes, nbytes=None):
    """Payload by the reference's host parser + Snappy codec; None where the
    reference rejects the frame (or its size is not ``nbytes``)."""
    try:
        tex = ref_parse_frame(fb).textures[0]
        if tex.texture_format != TextureFormat.YCoCg_DXT5:
            return None
        parts = []
        for i in range(tex.chunk_count):
            a = int(tex.chunk_compressed_offsets[i])
            blob = fb[a: a + int(tex.chunk_compressed_sizes[i])]
            parts.append(ref_pyref.decompress(blob)
                         if tex.chunk_compressors[i] == 0x0B else blob)
    except (RefHapError, ValueError, IndexError):
        return None
    out = b"".join(parts)
    return out if nbytes is None or len(out) == nbytes else None


FUZZ_H, FUZZ_W, FUZZ_CHUNKS = 32, 64, 4


def _fuzz_frame(img):
    payload = tl.words_to_payload(encode_blocks(torch.from_numpy(img)))
    frame, flen = encode_frame_device(payload, FUZZ_CHUNKS, FORMAT_YCOCG_DXT5,
                                      G, row_bytes=G * FUZZ_W // 4)
    return frame.numpy().copy(), int(flen), payload.numpy()


def _decodes(frame, flen):
    """Port decode; ok=True must mean the reference host decoder accepts the
    same bytes with the same payload."""
    nbytes = FUZZ_H * FUZZ_W
    out, ok = decode_frame_device(torch.from_numpy(frame), nbytes,
                                  FUZZ_CHUNKS, FORMAT_YCOCG_DXT5, G)
    if bool(ok):
        host = _host_payload(frame[:flen].tobytes(), nbytes)
        assert host is not None, "port accepted a frame the host rejects"
        assert out.numpy().tobytes() == host
    return bool(ok)


def _check_decoder_fuzz():
    complex_ = _fuzz_frame(np.full((FUZZ_H, FUZZ_W, 3), 77, np.uint8))
    raw = _fuzz_frame(_rand_img(2, FUZZ_H, FUZZ_W))
    assert complex_[0][3] >> 4 == 0xC and raw[0][3] >> 4 == 0xA
    nbytes = FUZZ_H * FUZZ_W
    for frame, flen, payload in (complex_, raw):
        out, ok, reasons = decode_frame_device(
            torch.from_numpy(frame), nbytes, FUZZ_CHUNKS, FORMAT_YCOCG_DXT5,
            G, with_reasons=True)
        assert bool(ok) and reasons.tolist() == [1, 1, 1, 1, 1]
        np.testing.assert_array_equal(out.numpy(), payload)
        words, _ = decode_frame_device(torch.from_numpy(frame[:flen]), nbytes,
                                       FUZZ_CHUNKS, FORMAT_YCOCG_DXT5, G,
                                       out_words=True)
        np.testing.assert_array_equal(words.numpy(), payload.view(np.int32))
        # single-byte corruptions: never crash, ok only with host agreement
        rng = np.random.default_rng(7)
        for pos in list(range(min(48, flen))) + sorted(
                rng.integers(48, flen, 32).tolist()):
            for delta in (1, 0x80):
                f = frame.copy()
                f[pos] ^= delta
                _decodes(f, flen)

    frame, flen, _ = complex_
    for pos in range(16):  # structural bytes of a Complex frame
        for delta in (1, 0x80):
            f = frame.copy()
            f[pos] ^= delta
            assert not _decodes(f, flen), (pos, delta)
    f = frame.copy()
    f[4 + 4 + 4 + FUZZ_CHUNKS + 4] ^= 0x40  # first size entry
    assert not _decodes(f, flen)
    # a compressor byte flipped from Snappy to raw leaves a size entry != S:
    # the raw-chunk path must reject it
    f = frame.copy()
    assert f[4 + 8] == 0x0B
    f[4 + 8] = 0x0A
    _, ok, reasons = decode_frame_device(
        torch.from_numpy(f), nbytes, FUZZ_CHUNKS, FORMAT_YCOCG_DXT5, G,
        with_reasons=True)
    assert not bool(ok) and reasons.tolist()[4] == 0
    assert not _decodes(np.zeros_like(frame), flen)
    torn = frame.copy()
    torn[flen // 2:] = 0
    assert not _decodes(torn, flen)
    for nib in (0x00, 0x5F, 0xBF, 0xCE):
        f = frame.copy()
        f[3] = nib
        assert not _decodes(f, flen)


# ---------------------------------------------------------------------------
# the foreign-frame path: Snappy compressor, op tables, kernels F and G
# ---------------------------------------------------------------------------

FOREIGN_SIZES = (1, 127, 128, 129, 4096, 12960)


def _foreign_payload(kind, n, rng):
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "flat":
        return bytes([int(rng.integers(0, 256))]) * n
    out = np.tile(rng.integers(0, 256, 48, dtype=np.uint8), n // 48 + 1)[:n]
    out[n // 2:] = rng.integers(0, 4, n - n // 2)  # short-offset repeats
    return out.tobytes()


def _handmade_streams():
    """(stream, decoded): 2-5 byte literal headers; copy-1, copy-2 and
    copy-4 elements with offsets 1-7 (overlapping) and longer."""
    out = []
    for hlen, n in ((2, 200), (3, 5000), (4, 300), (5, 70)):
        data = bytes((i * 7 + hlen) & 255 for i in range(n))
        out.append((pyref.write_varint(n) + bytes([(58 + hlen) << 2])
                    + (n - 1).to_bytes(hlen - 1, "little") + data, data))
    expect = bytearray(range(97, 105))
    st = bytearray([7 << 2]) + expect
    for kind, off, ln in ([(k, d, n) for d in range(1, 8)
                           for k, n in ((1, 11), (2, 64), (3, 33))]
                          + [(1, 700, 9), (3, 760, 64), (2, 500, 1)]):
        if kind == 1:
            st += bytes([1 | ((ln - 4) << 2) | ((off >> 8) << 5), off & 255])
        else:
            st += bytes([kind | ((ln - 1) << 2)]) + off.to_bytes(
                2 if kind == 2 else 4, "little")
        for _ in range(ln):
            expect.append(expect[-off])
    out.append((pyref.write_varint(len(expect)) + bytes(st), bytes(expect)))
    return out


def _corrupt_streams():
    """(stream, expected length) the general decoders must reject: the
    malformed cases of tests/test_snappy_general.py and the rules' edges."""
    v = ref_pyref.write_varint
    good = ref_pyref.compress(bytes(range(200)) * 3)
    lit4 = bytes([3 << 2]) + b"abcd"
    return [
        (good[: len(good) // 2], 600),  # truncated
        (v(400) + good[len(v(600)):], 600),  # preamble != expected
        (v(8) + lit4 + bytes([2 | (3 << 2), 0, 0]), 8),  # offset 0
        (v(8) + lit4 + bytes([2 | (3 << 2), 200, 0]), 8),  # past produced
        (v(8) + lit4 + bytes([1, 5]), 8),  # copy-1, offset = produced + 1
        (v(8) + lit4 + bytes([3 | (7 << 2), 4, 0, 0, 0]), 8),  # past out_len
        (v(4) + bytes([7 << 2]) + b"abcdefgh", 4),  # literal past out_len
        (v(8) + bytes([7 << 2]) + b"abcd", 8),  # literal past stream end
        (v(4) + lit4 + b"\xff\xff", 4),  # trailing bytes
        (b"\xff" * 6 + b"aaaa", 4),  # varint never terminates
        (b"\x80\x80\x80\x80\x80\x01", 4),  # 6-byte varint
        (b"", 4),  # empty
        (v(8) + bytes([63 << 2, 0xFF, 0xFF, 0xFF, 0xFF]) + b"abcdefgh", 8),
        # length 2^31 - 9: the sums wrap in int32 (ROADMAP queue 3)
        (v(64) + bytes([11 << 2]) + bytes(12)
         + bytes([63 << 2, 0xF6, 0xFF, 0xFF, 0x7F]) + bytes(40), 64),
        (v(8) + bytes([62 << 2, 0xFF, 0xFF]), 8),  # truncated header
        (v(8) + lit4 + bytes([2 | (3 << 2), 4]), 8),  # truncated copy-2
    ]


def _foreign_streams():
    """Streams of the module checks with their expected lengths: the
    port's compressor on random, flat and structured payloads at every
    FOREIGN_SIZES, hand-made streams, corrupt streams, and single-byte
    corruptions of a few of them."""
    rng = np.random.default_rng(21)
    streams, lens = [], []
    for n in FOREIGN_SIZES:
        for kind in ("random", "flat", "structured"):
            streams.append(pyref.compress(_foreign_payload(kind, n, rng)))
            lens.append(n)
    for st, data in _handmade_streams():
        streams.append(st)
        lens.append(len(data))
    for st, n in _corrupt_streams():
        streams.append(st)
        lens.append(n)
    for i in (5, 12, 14, 18):
        for _ in range(8):
            b = bytearray(streams[i])
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
            streams.append(bytes(b))
            lens.append(lens[i])
    return streams, lens


def _check_compressor_matches_reference():
    rng = np.random.default_rng(22)
    for n in (0, 14, 15, 1000, 65536, 70001):
        for kind in ("random", "flat", "structured"):
            data = _foreign_payload(kind, n, rng) if n else b""
            mine = pyref.compress(data)
            assert mine == ref_pyref.compress(data), (kind, n)
            assert ref_pyref.decompress(mine, n) == data
    assert pyref.write_varint(129600) == bytes([0xC0, 0xF4, 0x07])


def _check_op_tables_match_reference(streams, lens):
    for pm in (0, 128):
        mine = optable.pack_tables(streams, lens, promote_max=pm)
        ref = ref_optable.pack_tables(streams, lens, prefer_native=False,
                                      promote_max=pm)
        for f in ("ops", "n_ops", "lit", "n_lit", "out_len", "ok"):
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          getattr(ref, f), err_msg=f)
        assert mine.S_max == ref.S_max
    for st, n in zip(streams, lens):
        assert (optable.build_op_table(st, n) is None) == (
            ref_optable.build_op_table(st, n) is None)
    with pytest.raises(ValueError):
        optable.execute_table_host(optable.OpTable(
            np.array([[4, 2]], np.int32), np.zeros(0, np.uint8), 4))


def _check_exec_plain_on_reference_tables(streams, lens):
    """Kernel G's plain version replays the reference compiler's own
    tables as the reference's scalar executor does."""
    S = max(lens) + (-max(lens)) % 4  # word output needs whole words
    for pm, words in ((0, False), (128, True)):
        p = packed_tables_from_numpy(ref_optable.pack_tables(
            streams, lens, prefer_native=False, promote_max=pm, S_max=S))
        out = execute_op_tables(p.ops, p.n_ops, p.lit, p.out_len, S,
                                out_words=words)
        assert out.shape == ((len(streams), S // 4) if words
                             else (len(streams), S))
        out = out.view(torch.uint8).numpy() if words else out.numpy()
        for c, (st, n) in enumerate(zip(streams, lens)):
            t = ref_optable.build_op_table(st, n, promote_max=pm)
            if t is None:
                assert not p.ok[c] and int(p.n_ops[c]) == 0
                assert not out[c].any()  # rejected rows come out zero
                continue
            want = ref_optable.execute_table_host(t)
            assert out[c, :n].tobytes() == want, (pm, c)
            assert not out[c, n:].any()
            assert optable.execute_table_host(t) == want


def _check_general_plain_matches_pyref(streams, lens):
    """Kernel F's plain version: bytes and verdict of the reference's
    pure-Python decoder (expected_length = out_len <= S_max)."""
    S_max = max(lens)
    B = max(len(st) for st in streams)
    rows = np.zeros((len(streams), B), np.uint8)
    for i, st in enumerate(streams):
        rows[i, :len(st)] = np.frombuffer(st, np.uint8)
    out, ok = decode_any_streams(
        torch.from_numpy(rows), torch.tensor([len(st) for st in streams],
                                             dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32), S_max)
    bad = 0
    for c, (st, n) in enumerate(zip(streams, lens)):
        try:
            want = ref_pyref.decompress(st, expected_length=n)
        except RefHapError:
            want = None
        assert bool(ok[c]) == (want is not None), c
        if want is None:
            bad += 1
            continue
        assert out[c, :n].numpy().tobytes() == want
        assert not out[c, n:].any()
    assert bad >= len(_corrupt_streams())
    # a stream longer than its row reads zeros past the row; an out_len
    # above S_max is rejected
    st = pyref.compress(bytes(300))
    one = torch.from_numpy(np.frombuffer(st, np.uint8).copy())[None]
    for clen, ulen, S in ((len(st), 300, 300), (len(st) + 4, 300, 300),
                          (len(st), 300, 299)):
        o, k = decode_any_streams(one, torch.tensor([clen], dtype=torch.int32),
                                  torch.tensor([ulen], dtype=torch.int32), S)
        assert bool(k[0]) == (clen == len(st) and S >= ulen)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

H, W, CHUNKS = 64, 128, 4


@pytest.fixture(scope="module")
def reference():
    """The reference's own main path on a 64x128 natural frame:
    encode_pipeline + decode_pipeline, the only two JAX pipeline compiles of
    this file. XLA executables stay mapped while JAX caches them, so a
    worker that compiled much before must not meet the process's map limit
    inside these compiles: start and end with clean caches."""
    jax.clear_caches()
    img = bench_content.make_frame("natural", 0, H, W)
    frame, flen = jpipe.encode_pipeline(jnp.asarray(img), "hap_q", CHUNKS)
    out, ok = jpipe.decode_pipeline(frame, H, W, "hap_q", CHUNKS)
    assert bool(ok)
    frame, out = np.asarray(frame), np.asarray(out)
    jax.clear_caches()
    return img, frame, int(flen), out


def _check_slice_against_reference(img, frame, flen, ref_out):
    payload = _host_payload(frame[:flen].tobytes())
    ref_words = np.frombuffer(payload, "<u4")

    # frame bytes from the reference's words: LZ plan, emission, assembly
    mine, mine_len = encode_words(words_from_numpy(ref_words), H, W, CHUNKS)
    assert int(mine_len) == flen
    np.testing.assert_array_equal(mine.numpy(), frame)

    # bit-exact decode of the reference's frame
    dec, ok = decode_pipeline(frame, H, W, "hap_q", CHUNKS, device="cpu")
    assert bool(ok)
    np.testing.assert_array_equal(dec.numpy(), ref_out)

    # the port's own encode
    words = encode_blocks(torch.from_numpy(img))
    y0, y1, c0, c1 = (_u32(w) for w in tl.deinterleave_words(words, 4))
    r = ref_words.reshape(-1, 4)
    np.testing.assert_array_equal(y0, r[:, 0])
    np.testing.assert_array_equal(y1, r[:, 1])
    bc1_diff = (c0 != r[:, 2]) | (c1 != r[:, 3])
    assert bc1_diff.sum() <= 0.01 * len(bc1_diff), int(bc1_diff.sum())
    out, _, ok2 = roundtrip_pipeline(img, "hap_q", CHUNKS, device="cpu")
    assert bool(ok2)
    assert abs(_psnr(out.numpy(), img) - _psnr(ref_out, img)) <= 0.05


def _check_roundtrip_on_host(cls):
    img = make_frame(cls, 1, H, W)
    frame, flen = encode_pipeline(img, "hap_q", CHUNKS, device="cpu")
    fb = frame[: int(flen)].numpy().tobytes()
    tex = parse_frame(fb).textures[0]
    assert tex.format_id == 0xF and tex.decoded_bytes == H * W
    payload = b"".join(
        pyref.decompress(fb[a: a + n], S) if comp == 0x0B else fb[a: a + n]
        for comp, a, n, S in zip(
            tex.chunk_compressors, tex.chunk_compressed_offsets.tolist(),
            tex.chunk_compressed_sizes.tolist(),
            tex.chunk_uncompressed_sizes.tolist()))
    words = encode_blocks(torch.from_numpy(img))
    assert payload == tl.words_to_payload(words).numpy().tobytes()
    assert payload == _host_payload(fb)
    out, ok = decode_pipeline(frame, H, W, "hap_q", CHUNKS, device="cpu")
    assert bool(ok) and out.shape == (H, W, 3)
    assert _psnr(out.numpy(), img) > {"natural": 40, "graphics": 40,
                                      "noise": 15}[cls]


def _check_host_copies():
    data = np.tile(np.random.default_rng(9).integers(0, 256, 5, dtype=np.uint8),
                   400).tobytes()
    stream = ref_pyref.compress(data)  # copy-1 and copy-2 elements
    assert pyref.decompress(stream, len(data)) == data
    with pytest.raises(HapError):
        pyref.decompress(stream[:-1], len(data))
    frame, flen = encode_pipeline(make_frame("graphics", 3, 32, 64), "hap_q",
                                  2, device="cpu")
    fb = frame[: int(flen)].numpy().tobytes()
    mine, ref = parse_frame(fb).textures[0], ref_parse_frame(fb).textures[0]
    assert ref.texture_format == TextureFormat.YCoCg_DXT5
    for field in ("chunk_compressors", "chunk_compressed_offsets",
                  "chunk_compressed_sizes", "chunk_uncompressed_sizes"):
        np.testing.assert_array_equal(getattr(mine, field), getattr(ref, field))
    with pytest.raises(HapError):
        parse_frame(fb[:-1])


def _check_content_settings_and_state():
    for cls in ("natural", "graphics", "noise"):
        np.testing.assert_array_equal(make_frame(cls, 4, 48, 80),
                                      bench_content.make_frame(cls, 4, 48, 80))
    np.testing.assert_array_equal(make_gop(4, 24, 40),
                                  bench_content.make_gop(4, 24, 40))
    for effort in ("high", "fast"):
        assert encode_settings(effort) == (jpipe._refine(effort),
                                           jpipe._cands(effort))
    with pytest.raises(ValueError):
        encode_settings("medium")
    for nbytes, cc in ((8294400, 64), (2048 * 16, 7), (16 * 45, 64)):
        assert legalize_chunk_count(nbytes, 16, cc) == \
            ref_legalize(nbytes, TextureFormat.YCoCg_DXT5, cc)
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, 8, dtype=np.uint32)
    np.testing.assert_array_equal(_u32(words_from_numpy(words)), words)
    arrays = [rng.integers(-2**31, 2**31, s, dtype=np.int64).astype(np.int32)
              for s in ((2, 64, 2), (2, 64, 2), (2, 2, 2), (2,), (2,))]
    for a, b in zip(arrays, lz_plan_from_numpy(*arrays)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), a)
    with pytest.raises(TypeError):
        words_from_numpy(np.zeros(3, np.float32))


def _check_device_rules():
    img = make_frame("graphics", 0, 8, 8)
    with pytest.raises(NotImplementedError):
        encode_pipeline(img, "hap", 1, device="cpu")
    with pytest.raises(NotImplementedError):
        DeviceSession(8, 8, "hap", 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            roundtrip_pipeline(img, "hap_q", 1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceSession(8, 8, "hap_q", 1)
    root = Path(__file__).resolve().parent.parent
    pat = re.compile(r"^\s*(import|from)\s+(jax|hap_tpu\b|tools)", re.M)
    for f in sorted((root / "hap_tpu_torch").rglob("*.py")) + [
            root / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f"{f} imports the reference"


def test_port_modules_match_reference(reference_plan):
    _load_port()
    for h, w in SHAPES:
        _check_layout_ycocg_bc4(h, w)
    _check_single_channel_planes()
    _check_word_interleave(4, 300)
    _check_word_interleave(2, 128)
    _check_payload_views()
    _check_decoders_on_random_words()
    _check_bc1_encode_parity()

    _check_static_planning_facts()
    _check_plan_and_emission(*reference_plan)
    _check_lz_decode_roundtrip()
    _check_lz_decode_rejects_out_of_profile_streams()
    _check_stitch()
    _check_raw_chunks()

    streams, lens = _foreign_streams()
    _check_compressor_matches_reference()
    _check_op_tables_match_reference(streams, lens)
    _check_exec_plain_on_reference_tables(streams, lens)
    _check_general_plain_matches_pyref(streams, lens)

    _check_rle_profile_against_reference()

    _check_no_kernel_launches()
    jax.clear_caches()  # this test's own compiles, as the fixture's


def test_frames_match_serializer_and_survive_fuzz():
    _load_port()
    for kind, chunks in (("mixed", 8), ("random", 4), ("flat", 16)):
        _check_frame_bytes_match_host_serializer(kind, chunks)
    _check_decoder_fuzz()
    with _device_lz("0"):  # the RLE profile's frames, and its decoder fuzzed
        for kind, chunks in (("mixed", 8), ("random", 4), ("flat", 16)):
            _check_frame_bytes_match_host_serializer(kind, chunks)
        _check_decoder_fuzz()
    _check_no_kernel_launches()


def test_slice_matches_reference_main_path(reference):
    _load_port()
    _check_slice_against_reference(*reference)
    for cls in ("natural", "graphics", "noise"):
        _check_roundtrip_on_host(cls)
    _check_host_copies()
    _check_content_settings_and_state()
    _check_device_rules()
    _check_foreign_frames()
    _check_slice_rle_against_reference(*reference)
    _check_sessions()
    _check_no_kernel_launches()
    jax.clear_caches()  # the reference codec's compiles, as the fixture's


def _foreign_frames():
    """64x128 Hap Q frames: the reference encoder's (chunk_count=4), a
    non-uniform one (offset table, shuffled storage, uneven sizes, mixed
    raw/Snappy), and a corrupted copy of the encoder's frame; with the
    reference host decode of the first."""
    from tests.test_container import _build_complex_frame_with_offsets

    img = make_frame("graphics", 5, H, W)
    enc = jcodecs.encode_frame(jnp.asarray(img), "hap_q", chunk_count=4)
    ref = np.asarray(jcodecs.decode_frame(enc, H, W))
    tex = ref_parse_frame(enc).textures[0]
    assert tex.chunk_count == 4 and (tex.chunk_compressors == 0x0B).all()
    payload = b"".join(
        ref_pyref.decompress(enc[a: a + n])
        for a, n in zip(tex.chunk_compressed_offsets.tolist(),
                        tex.chunk_compressed_sizes.tolist()))
    chunks, o = [], 0
    for k, n in enumerate((1024, 3072, 512, 2048, len(payload) - 6656)):
        part = payload[o: o + n]
        o += n
        chunks.append({"snappy": k % 2 == 0,
                       "payload": ref_pyref.compress(part) if k % 2 == 0
                       else part})
    nonu = _build_complex_frame_with_offsets(chunks, fmt_id=0xF, shuffle=True)
    bad = bytearray(enc)  # chunk 2's first element: a ~4 GB literal
    a = int(tex.chunk_compressed_offsets[2]) + len(
        ref_pyref.write_varint(int(tex.chunk_uncompressed_sizes[2])))
    bad[a: a + 5] = bytes([63 << 2, 0xFF, 0xFF, 0xFF, 0xFE])
    return enc, nonu, bytes(bad), ref


def _check_foreign_frames():
    enc, nonu, bad, ref = _foreign_frames()
    np.testing.assert_array_equal(jcodecs.decode_frame(nonu, H, W), ref)
    for route in ("table", "kernel"):
        for fr in (enc, nonu):
            pix, ok = decode_frame_any_device(fr, H, W, snappy=route,
                                              device="cpu")
            assert bool(ok) and pix.dtype == torch.uint8
            np.testing.assert_array_equal(pix.numpy(), ref)
        _, ok = decode_frame_any_device(bad, H, W, snappy=route, device="cpu")
        assert not bool(ok)
        pix, ok = decode_frame_any(nonu, H, W, snappy=route, device="cpu")
        assert ok and np.array_equal(pix, ref)
    with pytest.raises(NotImplementedError):
        decode_frame_any(enc, H, W, via="native", device="cpu")
    with pytest.raises(ValueError):
        decode_frame_any_device(enc, H, W, snappy="general", device="cpu")
    with pytest.raises(HapError):  # dims that do not match the texture
        decode_frame_any_device(enc, H, W * 2, device="cpu")
    other = serialize_texture(bytes(H * W // 2), TextureFormat.RGB_DXT1,
                              Compressor.NONE)
    with pytest.raises(NotImplementedError, match="RGB_DXT1"):
        decode_frame_any_device(other, H, W, device="cpu")

    for frames, promotes in (((enc, enc), ("pieces", "auto", 0)),
                             ((nonu, nonu), ("pieces",))):
        for promote in promotes:
            sess = ForeignGopSession(H, W, promote=promote, device="cpu")
            staged = [sess.stage(f) for f in frames]
            pix, ok = sess.decode_gop(staged)
            assert ok.tolist() == [True, True]
            for k in range(2):
                np.testing.assert_array_equal(pix[k].numpy(), ref)
            jsess = jany.ForeignGopSession(H, W, promote=promote)
            jstaged = [jsess.stage(f) for f in frames]
            assert staged[0].profile == jstaged[0].profile
            assert sess.hbm_bytes_per_frame(staged[0]) == \
                jsess.hbm_bytes_per_frame(jstaged[0])
    staged = [sess.stage(enc), sess.stage(nonu)]  # two profiles
    with pytest.raises(AssertionError):
        jsess.decode_gop([jsess.stage(enc), jsess.stage(nonu)])
    with pytest.raises(ValueError, match="uniform frame profile"):
        sess.decode_gop(staged)
    pix, ok = sess.decode_gop([sess.stage(bad), staged[0]])
    assert ok.tolist() == [False, True]
    np.testing.assert_array_equal(pix[1].numpy(), ref)
    assert sess.compile_stats() == {"profiles_seen": 2,
                                    "compiled_programs": 0,
                                    "cache_evictions": 0, "max_profiles": 16}
    with pytest.raises(ValueError):
        ForeignGopSession(H, W, promote="fast", device="cpu")


def _check_slice_rle_against_reference(img, frame, flen, ref_out):
    """The RLE profile around the reference fixture's words (S = 2048, a
    tail-only chunk): the port's frame equals the host serializer's
    around the reference's XLA streams and decodes to the fixture's
    pixels."""
    payload = _host_payload(frame[:flen].tobytes())
    S = len(payload) // CHUNKS
    streams, lens, _ = _reference_rle(
        np.frombuffer(payload, np.uint8).reshape(CHUNKS, S), S)
    host = serialize_texture(
        payload, TextureFormat.YCoCg_DXT5, Compressor.SNAPPY, CHUNKS,
        precompressed=[streams[c, :lens[c]].tobytes() for c in range(CHUNKS)])
    with _device_lz("0"):
        mine, mine_len = encode_words(
            words_from_numpy(np.frombuffer(payload, "<u4")), H, W, CHUNKS)
        assert mine[:int(mine_len)].numpy().tobytes() == host
        dec, ok = decode_pipeline(mine, H, W, "hap_q", CHUNKS, device="cpu")
    assert bool(ok)
    np.testing.assert_array_equal(dec.numpy(), ref_out)


def _session_frames():
    """Three 64x128 frames: flat (Snappy chunks under both profiles), half
    flat, and noise (stored whole-frame raw)."""
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    frames[0] = 50
    frames[1, :H // 2] = 90
    return frames


def _check_session_stats(frames, encoded, stats, rows):
    for fb, st in zip(encoded, stats):
        assert st.frame_bytes == len(fb)
        assert st.compression_ratio == st.input_bytes / len(fb)
        tex = ref_parse_frame(fb).textures[0]
        assert st.input_bytes == int(tex.chunk_uncompressed_sizes.sum())
        if tex.stored_compressor == 0xA:
            assert st.whole_frame_raw_sections == 1
            assert st.snappy_chunks == 0 and st.raw_chunk_fallbacks == 0
        else:
            snappy = int((tex.chunk_compressors == 0x0B).sum())
            assert st.whole_frame_raw_sections == 0
            assert st.snappy_chunks == snappy
            assert st.raw_chunk_fallbacks == st.chunk_count - snappy
    for r, st, fb in zip(rows, stats, encoded):
        assert vars(st) == vars(jsession.EncodeStats.from_rows(r, len(fb)))


def _check_sessions():
    """DeviceSession under both profiles: stats against the host parse of
    its frames and the reference's EncodeStats; reasons for a corrupted
    format nibble and a corrupted compressor table."""
    assert DECODE_REASONS == jsession.DECODE_REASONS
    frames = _session_frames()
    for lz in ("1", "0"):
        with _device_lz(lz):
            sess = DeviceSession(H, W, "hap_q", CHUNKS, batch=2,
                                 device="cpu")
            encoded, stats = sess.encode_with_stats(frames)
            rows = [encode_pipeline_stats(f, "hap_q", CHUNKS,
                                          device="cpu")[2].numpy()
                    for f in frames]
            out, flen, ok = sess.roundtrip(frames)
            assert encoded == sess.encode(frames)
            imgs, ok2 = sess.decode_bytes(encoded)
            fmax = max(map(len, encoded))
            padded = np.zeros((len(frames), fmax), np.uint8)
            for i, fb in enumerate(encoded):
                padded[i, :len(fb)] = np.frombuffer(fb, np.uint8)
            bad = padded.copy()
            bad[1, 3] = (bad[1, 3] & 0xF0) | 0x5  # format nibble
            assert bad[0, 3] >> 4 == 0xC  # complex
            bad[0, 12] = 0x07  # unknown chunk compressor
            _, okr, reasons = sess.decode_with_reasons(bad)
        assert ok.all() and ok2.all() and out.shape == (3, H, W, 3)
        np.testing.assert_array_equal(out, imgs)
        assert flen.tolist() == [len(fb) for fb in encoded]
        assert {st.whole_frame_raw_sections for st in stats} == {0, 1}
        assert stats[0].snappy_chunks == CHUNKS
        _check_session_stats(frames, encoded, stats, rows)
        assert all(_host_payload(fb) is not None for fb in encoded)
        assert okr.tolist() == [False, False, True]
        assert reasons[1]["format_nibble"] == [False]
        assert all(reasons[1][k] == [True] for k in DECODE_REASONS
                   if k != "format_nibble")
        assert reasons[0]["tables"] == [False]
        assert all(all(v) for v in reasons[2].values())
        if lz == "1":
            lz_pixels = out
        else:  # both profiles carry the same words
            np.testing.assert_array_equal(out, lz_pixels)


def _check_no_kernel_launches():
    """Every CPU run went through the plain versions only."""
    for k in (LZ_EMIT, LZ_DECODE, STITCH, RAW_CHUNKS, EXEC_TABLES,
              GENERAL_DECODE, RLE_COMPACT, RLE_DECODE):
        assert k.launches == 0, k.name
