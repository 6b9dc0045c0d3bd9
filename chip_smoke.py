#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hap_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own line(s):
  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA kernel in hap_tpu_torch/csrc (nvcc, one process per source);
  2. each kernel against its plain PyTorch version on the card's inputs at
     the main path's shapes -- 4K (3840x2160) Hap Q frames at 64 chunks of
     the natural, graphics and noise classes -- plus hand-corrupted
     streams that must be flagged not-ok;
  3. the main path end to end: roundtrip_pipeline(img, "hap_q", 64) on the
     three frames, with every kernel's launch count read around that run;
     each frame must parse and decompress on the host with the port's own
     parser and pure-Python Snappy codec, and decode to the same pixels as
     the CPU decode of the same words;
  4. times: encode, decode and roundtrip ms per frame and each kernel's ms
     per launch (CUDA events, synchronised each iteration);
  5. where the device time goes (torch.profiler) over three roundtrips.
The foreign-frame decode path (pipeline/any_frame.py, kernels F and G)
adds to each phase: 2. F and G against their plain versions on the 64
google-snappy chunk streams (the port's pyref.compress) of each class's
4K payload, on their op tables (promote_max 128 and 0), on one 512-chunk
table launch over an 8-frame graphics GOP, and on hand-made and
hand-corrupted streams; 3. decode_frame_any_device on both routes over a
hap.c-layout frame and a non-uniform frame (offset table, shuffled
storage, uneven sizes, mixed raw/Snappy, 8-byte header) per class, the
GOP through ForeignGopSession, and a corrupted frame; 4. their times and
the host stage split; 5. one profiled decode_gop.
The RLE profile (HAP_TPU_DEVICE_LZ=0; kernels E and D(ii)) and the serving
session add: 2. E and D(ii) against their plain versions on all 64 chunks
of the three classes' payloads, on synthetic payloads that force every
unit flavor at 4K, at S = 2048 (a seeded tail) and at S = 131072 (no
tail), and on corrupted streams (preamble, seed and copy tags, pattern
bytes, comp_len off by one, a raw chunk whose size entry is not S); 3.
DeviceSession(2160, 3840, "hap_q", 64) under HAP_TPU_DEVICE_LZ=0 over
the three frames -- roundtrip, encode_with_stats, decode_with_reasons --
with every kernel's launch count read around it: pixels equal the LZ
profile's, frames decompress on the host, stats and reasons match the
frames; then the session once on the LZ default; 4. E and D(ii) per
launch, the RLE roundtrip per frame and the session per batch; 5. one
profiled RLE roundtrip and the device time of E and D(ii).
Then one JSON line with the kernels' numbers and, last, the result line.
Exits nonzero on any failure; without CUDA (or outside a checkout) it
exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import types

H, W, CHUNKS = 2160, 3840, 64
CLASSES = ("natural", "graphics", "noise")
G = 16
TIMED_ITERS = 10
FOREIGN_GOP = 8  # frames of the foreign graphics GOP (bench.py's row)
ROUTES = ("table", "kernel")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import hap_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository "
              "(hap_tpu_torch not found)", file=sys.stderr)
        return 2
    try:
        return run(torch, torch.device("cuda", 0))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1


def run(torch, dev) -> int:
    import numpy as np

    from hap_tpu_torch import _build
    from hap_tpu_torch.constants import FORMAT_YCOCG_DXT5, dxt_payload_bytes
    from hap_tpu_torch.container.parse import parse_frame
    from hap_tpu_torch.content import make_frame
    from hap_tpu_torch.kernels.layout import words_to_payload
    from hap_tpu_torch.pipeline.device_frame import (
        _parse_tables,
        _stitch_inputs,
    )
    from hap_tpu_torch.pipeline.device_pipeline import (
        decode_blocks,
        decode_pipeline,
        encode_blocks,
        encode_pipeline,
        plan_chunks,
        roundtrip_pipeline,
    )
    from hap_tpu_torch.snappy import pyref
    from hap_tpu_torch.snappy.device_lz import (
        SEG_SLOTS,
        LzPlan,
        _varint,
        plan_lz,
    )
    from hap_tpu_torch.snappy.lz_kernels import (
        LZ_DECODE,
        LZ_EMIT,
        decode_lz_streams_from_frame,
        emit_lz_streams,
    )
    from hap_tpu_torch.snappy.exec_kernels import EXEC_TABLES
    from hap_tpu_torch.snappy.general_kernels import GENERAL_DECODE
    from hap_tpu_torch.snappy.rle_kernels import RLE_COMPACT, RLE_DECODE
    from hap_tpu_torch.snappy.stream_kernels import (
        RAW_CHUNKS,
        STITCH,
        raw_chunks_from_frame,
        stitch_streams,
    )

    sync = torch.cuda.synchronize

    # ---- phase 1: the card, the build -----------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    # HBM rate of the card (NVIDIA data sheets): 3.35 TB/s SXM, 2.0 TB/s PCIe
    hbm = 2.0e12 if "PCIe" in kind else 3.35e12
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    check(len(sources) == 8 and all(_build.library(src) for src in sources),
          f"expected eight CUDA sources built and loaded, found {sources}")
    for src, rep in sorted(reports.items()):
        for ln in rep.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {src}: {ln.strip()}", file=sys.stderr)
    print(f"phase 1 build: {len(reports)} CUDA sources compiled in "
          f"{build_s:.1f} s ({', '.join(sources)}) [{card}]", flush=True)

    kernels = {"lz_emit": LZ_EMIT, "stitch": STITCH,
               "lz_decode_from_frame": LZ_DECODE,
               "raw_chunks_from_frame": RAW_CHUNKS}
    meta = {
        "lz_emit": ("lz_emit.cu", "hap_tpu/snappy/pallas_lz.py:50"),
        "stitch": ("stitch.cu", "hap_tpu/snappy/pallas_kernels.py:317"),
        "lz_decode_from_frame": ("lz_decode.cu",
                                 "hap_tpu/snappy/pallas_lz.py:318"),
        "raw_chunks_from_frame": ("raw_chunks.cu",
                                  "hap_tpu/snappy/pallas_kernels.py:465"),
    }
    foreign_kernels = {"general_decode": GENERAL_DECODE,
                       "exec_tables": EXEC_TABLES}
    meta["general_decode"] = ("general_decode.cu",
                              "hap_tpu/snappy/pallas_general.py:206")
    meta["exec_tables"] = ("exec_tables.cu",
                           "hap_tpu/snappy/pallas_exec.py:89")
    rle_kernels = {"rle_compact": RLE_COMPACT,
                   "rle_decode_from_frame": RLE_DECODE}
    meta["rle_compact"] = ("rle_compact.cu",
                           "hap_tpu/snappy/pallas_kernels.py:143")
    meta["rle_decode_from_frame"] = ("rle_decode.cu",
                                     "hap_tpu/snappy/pallas_kernels.py:465")
    stats = {k: {"err": 0, "plain_ms": [], "bytes": []} for k in kernels}

    nbytes = dxt_payload_bytes(W, H, G)
    cc = plan_chunks(H, W, CHUNKS)
    S = nbytes // cc
    row_bytes = G * W // 4

    def cpu(t):
        return t.cpu() if torch.is_tensor(t) else t

    def host_ms(fn):
        t = time.perf_counter()
        r = fn()
        return r, (time.perf_counter() - t) * 1e3

    def max_err(a, b):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int(d.max()) if d.numel() else 0

    def cuda_ms(fn, iters=TIMED_ITERS):
        fn()  # warm-up
        sync()
        ts = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            sync()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    # ---- phase 2: each kernel against its plain version -------------------
    imgs, inputs = {}, {}
    for seed, cls in enumerate(CLASSES):
        img = torch.from_numpy(make_frame(cls, seed, H, W)).to(dev)
        imgs[cls] = img
        payload = words_to_payload(encode_blocks(img))
        chunks = payload.reshape(cc, S)
        plan = plan_lz(chunks, S, G, row_bytes)
        plan_c = LzPlan(*(t.cpu() for t in plan))

        comp = emit_lz_streams(chunks, plan, S)                    # A
        comp_p, ms = host_ms(lambda: emit_lz_streams(chunks.cpu(), plan_c, S))
        stats["lz_emit"]["plain_ms"].append(ms)
        err = max_err(comp.cpu(), comp_p)
        stats["lz_emit"]["err"] = max(stats["lz_emit"]["err"], err)
        check(err == 0, f"{cls}: lz_emit != plain")
        nlit = plan_c.counts[:, :, 0]
        lit = plan_c.tables_lit.reshape(cc, -1, SEG_SLOTS, 2)[..., 0]
        live = torch.arange(SEG_SLOTS)[None, None, :] < nlit[..., None]
        lit_bytes = int(((lit >> 20) & 0x7FF)[live].sum())
        n_pieces = int(plan_c.n_pieces.sum())
        stats["lz_emit"]["bytes"].append(
            lit_bytes + 8 * n_pieces + plan_c.counts.numel() * 4 + 4 * cc
            + comp.numel())

        args, flen, _ = _stitch_inputs(payload, comp, plan.comp_len, cc,
                                       FORMAT_YCOCG_DXT5, G)      # B
        frame = stitch_streams(*args)
        frame_p, ms = host_ms(lambda: stitch_streams(*map(cpu, args)))
        stats["stitch"]["plain_ms"].append(ms)
        err = max_err(frame.cpu(), frame_p)
        stats["stitch"]["err"] = max(stats["stitch"]["err"], err)
        check(err == 0, f"{cls}: stitch != plain")
        header_len, lengths = int(args[1]), args[6]
        stats["stitch"]["bytes"].append(
            header_len + int(lengths.sum()) + 9 * cc + frame.numel())

        fpad, pos, csizes, cis, _, _ = _parse_tables(
            frame, nbytes, cc, FORMAT_YCOCG_DXT5, G)
        tables = (fpad, pos, csizes, cis)
        tables_c = tuple(t.cpu() for t in tables)
        raw = ~cis
        out_d, ok_d = raw_chunks_from_frame(*tables, S)              # D
        (out_dp, ok_dp), ms = host_ms(
            lambda: raw_chunks_from_frame(*tables_c, S))
        stats["raw_chunks_from_frame"]["plain_ms"].append(ms)
        rows = raw.cpu()
        err = max_err(out_d.cpu()[rows], out_dp[rows])
        stats["raw_chunks_from_frame"]["err"] = max(
            stats["raw_chunks_from_frame"]["err"], err)
        check(err == 0 and torch.equal(ok_d.cpu(), ok_dp),
              f"{cls}: raw_chunks_from_frame != plain")
        n_raw, n_comp = int(rows.sum()), int(cis.sum())
        stats["raw_chunks_from_frame"]["bytes"].append(2 * S * n_raw + 10 * cc)

        out_c = torch.zeros((cc, S), dtype=torch.uint8, device=dev)  # C
        ok_c = torch.zeros(cc, dtype=torch.bool, device=dev)
        decode_lz_streams_from_frame(*tables, S, out_c, ok_c)
        out_cp = torch.zeros((cc, S), dtype=torch.uint8)
        ok_cp = torch.zeros(cc, dtype=torch.bool)
        _, ms = host_ms(lambda: decode_lz_streams_from_frame(
            *tables_c, S, out_cp, ok_cp))
        stats["lz_decode_from_frame"]["plain_ms"].append(ms)
        err = max_err(out_c.cpu(), out_cp)
        stats["lz_decode_from_frame"]["err"] = max(
            stats["lz_decode_from_frame"]["err"], err)
        check(err == 0 and torch.equal(ok_c.cpu(), ok_cp),
              f"{cls}: lz_decode_from_frame != plain")
        comp_rows = cis.cpu()
        check(bool(ok_cp[comp_rows].all()) and torch.equal(
            out_cp[comp_rows], chunks.cpu()[comp_rows]),
            f"{cls}: compressed chunks did not decode to the payload")
        stats["lz_decode_from_frame"]["bytes"].append(
            int(csizes[cis].sum()) + S * n_comp + 10 * cc)
        inputs[cls] = dict(chunks=chunks, plan=plan, stitch=args,
                           tables=tables, payload=payload)
        print(f"phase 2 {cls}: lz_emit, stitch, raw_chunks_from_frame and "
              f"lz_decode_from_frame equal their plain versions over all {cc} "
              f"chunks ({n_comp} compressed, {n_raw} raw, frame "
              f"{int(flen)} B) [{card}]", flush=True)

    # hand-corrupted streams on the graphics frame
    fpad, pos, csizes, cis = inputs["graphics"]["tables"]
    fb = fpad.cpu().numpy()
    pos_c, size_c = pos.cpu().numpy(), csizes.cpu().numpy()
    comp_idx = np.flatnonzero(cis.cpu().numpy())

    def first_copy2(c):
        cur = int(pos_c[c]) + len(_varint(S))
        end = int(pos_c[c] + size_c[c])
        while cur < end:
            tag = int(fb[cur])
            if tag & 3 == 2:
                return cur
            t6 = tag >> 2
            tl, n = ((1, t6 + 1) if t6 < 60 else (2, int(fb[cur + 1]) + 1)
                     if t6 == 60 else
                     (3, int(fb[cur + 1]) + (int(fb[cur + 2]) << 8) + 1))
            cur += tl + n
        return None

    with_copy = [c for c in comp_idx if first_copy2(c) is not None]
    check(len(with_copy) >= 3 and len(comp_idx) >= 4,
          "graphics frame lacks compressed chunks to corrupt")
    bad = fpad.clone()
    c1, c2, c3 = with_copy[:3]
    c4 = [c for c in comp_idx if c not in (c1, c2, c3)][0]
    p1, p2 = first_copy2(c1), first_copy2(c2)
    bad[p1] = (int(fb[p1]) & ~3) | 1                   # copy-1 tag
    bad[p2 + 1], bad[p2 + 2] = 4, 0                    # offset 4 < 8
    bad[int(pos_c[c3])] ^= 1                           # bad preamble
    cis_bad = cis.clone()
    cis_bad[c4] = False  # compressor byte flipped: raw, size entry != S
    t_bad = (bad, pos, csizes, cis_bad)
    out_k, ok_k = raw_chunks_from_frame(*t_bad, S)
    decode_lz_streams_from_frame(*t_bad, S, out_k, ok_k)
    t_bad_c = tuple(t.cpu() for t in t_bad)
    out_p, ok_p = raw_chunks_from_frame(*t_bad_c, S)
    decode_lz_streams_from_frame(*t_bad_c, S, out_p, ok_p)
    check(torch.equal(out_k.cpu(), out_p) and torch.equal(ok_k.cpu(), ok_p),
          "corrupted streams: kernels != plain versions")
    want = torch.ones(cc, dtype=torch.bool)
    want[[c1, c2, c3, c4]] = False
    check(torch.equal(ok_p, want), "corrupted streams not flagged exactly: "
          f"not-ok {torch.nonzero(~ok_p).flatten().tolist()}, corrupted "
          f"{[c1, c2, c3, c4]}")
    print(f"phase 2 corrupted streams: copy-1 tag (chunk {c1}), offset < 8 "
          f"(chunk {c2}), bad preamble (chunk {c3}) and a raw chunk whose "
          f"size entry != S (chunk {c4}) flagged not-ok by kernels and plain "
          f"versions alike; all {cc - 4} other chunks ok [{card}]",
          flush=True)
    ctx = types.SimpleNamespace(
        torch=torch, dev=dev, S=S, cc=cc, check=check, inputs=inputs,
        stats=stats, host_ms=host_ms, max_err=max_err, cuda_ms=cuda_ms,
        card=card, hbm=hbm, sync=sync, time=time, imgs=imgs, lz_out={},
        rle_frames={})
    foreign_phase2(ctx)
    rle_phase2(ctx)

    # ---- phase 3: the main path end to end ----------------------------------
    launches = {k: 0 for k in kernels}
    psnr = {}
    for cls in CLASSES:
        img = imgs[cls]
        for k in kernels.values():
            k.launches = 0
        out, flen, ok = roundtrip_pipeline(img, "hap_q", CHUNKS, device=dev)
        sync()
        counts = {name: k.launches for name, k in kernels.items()}
        check(all(v > 0 for v in counts.values()),
              f"{cls}: a kernel was not launched on the main path: {counts}")
        for name, v in counts.items():
            launches[name] += v
        check(bool(ok), f"{cls}: roundtrip ok is False")

        frame, flen2 = encode_pipeline(img, "hap_q", CHUNKS, device=dev)
        check(int(flen2) == int(flen), f"{cls}: frame length differs")
        fbytes = frame[: int(flen)].cpu().numpy().tobytes()
        tex = parse_frame(fbytes).textures[0]
        check(tex.format_id == FORMAT_YCOCG_DXT5 and tex.decoded_bytes == nbytes,
              f"{cls}: host parse disagrees")
        payload = inputs[cls]["payload"].cpu().numpy().tobytes()
        for i in range(tex.chunk_count):
            a = int(tex.chunk_compressed_offsets[i])
            n = int(tex.chunk_compressed_sizes[i])
            u = int(tex.chunk_uncompressed_offsets[i])
            m = int(tex.chunk_uncompressed_sizes[i])
            blob = fbytes[a: a + n]
            if tex.chunk_compressors[i] == 0x0B:
                blob = pyref.decompress(blob, m)
            check(blob == payload[u: u + m],
                  f"{cls}: chunk {i} does not decompress to its payload")
        words = torch.from_numpy(np.frombuffer(payload, np.int32).copy())
        ref = decode_blocks(words, H, W)
        check(torch.equal(out.cpu(), ref),
              f"{cls}: GPU decode != CPU decode of the same words")
        d = out.to(torch.float64) - img[..., :3].to(torch.float64)
        psnr[cls] = float(10 * torch.log10(255.0 ** 2 / (d * d).mean()))
        ctx.lz_out[cls] = out
        print(f"phase 3 {cls}: roundtrip ok, frame {int(flen)} B "
              f"({tex.chunk_count} chunks, "
              f"{int((tex.chunk_compressors == 0x0B).sum())} Snappy) parses "
              f"and decompresses on the host, decode == CPU decode, PSNR "
              f"{psnr[cls]:.3f} dB, launches {counts} [{card}]", flush=True)
    print(f"phase 3 kernels: launches on the main path over the three frames "
          f"{json.dumps(launches)} [{card}]", flush=True)
    launches.update(foreign_phase3(ctx))
    launches.update(rle_phase3(ctx))

    # ---- phase 4: times -------------------------------------------------------
    frames = {c: encode_pipeline(imgs[c], "hap_q", CHUNKS, device=dev)[0]
              for c in CLASSES}
    e2e = {
        "encode": [cuda_ms(lambda: encode_pipeline(
            imgs[c], "hap_q", CHUNKS, device=dev)) for c in CLASSES],
        "decode": [cuda_ms(lambda: decode_pipeline(
            frames[c], H, W, "hap_q", CHUNKS, device=dev)) for c in CLASSES],
        "roundtrip": [cuda_ms(lambda: roundtrip_pipeline(
            imgs[c], "hap_q", CHUNKS, device=dev)) for c in CLASSES],
    }
    for name, ms in e2e.items():
        print(f"phase 4 {name}: " + ", ".join(
            f"{c} {m:.3f} ms" for c, m in zip(CLASSES, ms))
            + f"; median {statistics.median(ms):.3f} ms/frame [{card}]",
            flush=True)

    per = {k: {"ms": [], "lib": []} for k in kernels}
    for cls in CLASSES:
        inp = inputs[cls]
        chunks, plan, args, tables = (inp["chunks"], inp["plan"],
                                      inp["stitch"], inp["tables"])
        per["lz_emit"]["ms"].append(
            cuda_ms(lambda: emit_lz_streams(chunks, plan, S)))
        per["stitch"]["ms"].append(cuda_ms(lambda: stitch_streams(*args)))
        per["raw_chunks_from_frame"]["ms"].append(
            cuda_ms(lambda: raw_chunks_from_frame(*tables, S)))
        out_c = torch.empty((cc, S), dtype=torch.uint8, device=dev)
        ok_c = torch.empty(cc, dtype=torch.bool, device=dev)
        per["lz_decode_from_frame"]["ms"].append(cuda_ms(
            lambda: decode_lz_streams_from_frame(*tables, S, out_c, ok_c)))

        # library yardsticks (never called by the port): one torch gather
        header, header_len, comp, chk, src_comp, q, lengths, fmax = args
        hl = int(header_len)
        src = torch.cat([header[:hl], comp.reshape(-1), chk.reshape(-1),
                         torch.zeros(1, dtype=torch.uint8, device=dev)])
        i = torch.arange(fmax, device=dev)
        c = (torch.searchsorted(q.to(torch.int64), i, right=True) - 1).clamp(0)
        o = i - q.to(torch.int64)[c]
        base = torch.where(src_comp[c], hl + c * comp.shape[1],
                           hl + comp.numel() + c * S)
        idx = torch.where(i < hl, i, torch.where(
            o < lengths.to(torch.int64)[c], base + o, src.numel() - 1))
        check(torch.equal(torch.take(src, idx), stitch_streams(*args)),
              f"{cls}: the stitch yardstick computes something else")
        per["stitch"]["lib"].append(cuda_ms(lambda: torch.take(src, idx)))
        fpad, pos, csizes, cis = tables
        ridx = pos[~cis].to(torch.int64)[:, None] + torch.arange(S, device=dev)
        out_d, _ = raw_chunks_from_frame(*tables, S)
        check(torch.equal(fpad[ridx], out_d[~cis]),
              f"{cls}: the raw-chunk yardstick computes something else")
        per["raw_chunks_from_frame"]["lib"].append(
            cuda_ms(lambda: fpad[ridx]))
    for name, ms in foreign_phase4(ctx).items():
        per[name] = {"ms": ms, "lib": []}  # no torch call decodes Snappy
    for name, ms in rle_phase4(ctx).items():
        per[name] = {"ms": ms, "lib": []}  # nor encodes it

    # ---- phase 5: where the device time goes (torch.profiler) -----------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in CLASSES:
            roundtrip_pipeline(imgs[c], "hap_q", CHUNKS, device=dev)
        sync()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, device_ms = {}, {}
    for e in dev_events:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    if dev_events:
        span = (max(e.time_range.end for e in dev_events)
                - min(e.time_range.start for e in dev_events)) / 1e3
        busy = sum(t for t, _ in by_name.values()) / 1e3
        for name, symbol in (("lz_emit", "lz_emit_kernel"),
                             ("stitch", "stitch_kernel"),
                             ("lz_decode_from_frame", "lz_decode_kernel"),
                             ("raw_chunks_from_frame", "raw_chunks_kernel")):
            hits = [v for k, v in by_name.items() if symbol in k]
            if hits:
                device_ms[name] = (sum(t for t, _ in hits) / 1e3
                                   / sum(n for _, n in hits))
        mine = sum(v[0] for k, v in by_name.items()
                   if any(s in k for s in ("lz_emit_kernel", "stitch_kernel",
                                           "lz_decode_kernel",
                                           "raw_chunks_kernel"))) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        print(f"phase 5 profile (3 roundtrips, one per class): "
              f"{len(dev_events)} device ops, device busy {busy:.3f} ms of a "
              f"{span:.3f} ms window (idle {100 * (1 - busy / span):.1f}%); "
              f"kernels A-D {mine:.3f} ms, torch ops {busy - mine:.3f} ms "
              f"[{card}]", flush=True)
        for k, (t, n) in top:
            print(f"  {t / 1e3:8.3f} ms {n:5d}x {k[:110]}", flush=True)
    else:
        print(f"phase 5 profile: the profiler saw no device time [{card}]",
              flush=True)
    device_ms.update(foreign_profile(ctx, profile, ProfilerActivity))
    device_ms.update(rle_profile(ctx, profile, ProfilerActivity))

    rows = []
    for name in list(kernels) + list(foreign_kernels) + list(rle_kernels):
        src, replaces = meta[name]
        ms = statistics.mean(per[name]["ms"])
        lib = per[name]["lib"]
        bound = statistics.mean(stats[name]["bytes"]) / hbm * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"hap_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": stats[name]["err"],
            "ms": ms, "plain_ms": statistics.mean(stats[name]["plain_ms"]),
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": statistics.mean(lib) if lib else None,
            "device_ms": device_ms.get(name),
        })
        print(f"phase 4 {name}: " + ", ".join(
            f"{c} {m:.4f} ms" for c, m in zip(CLASSES, per[name]["ms"]))
            + f" per launch; bound {bound:.4f} ms (bytes at {hbm / 1e12} "
            f"TB/s); plain (host CPU) {rows[-1]['plain_ms']:.1f} ms"
            + (f"; torch gather {rows[-1]['library_ms']:.4f} ms"
               if lib else "") + f" [{card}]", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the foreign-frame decode path: kernels F (general_decode) and G
# (exec_tables), pipeline/any_frame.py
# ---------------------------------------------------------------------------

def foreign_profile(ctx, profile, activity):
    """Device busy and idle share of one decode_gop (the foreign GOP) and of
    one kernel-route decode; returns device ms per launch of F and G."""
    from hap_tpu_torch.pipeline.any_frame import decode_frame_any_device

    torch, (sess, staged) = ctx.torch, ctx.f_session
    windows = (
        (f"one decode_gop of the {FOREIGN_GOP}-frame foreign GOP",
         lambda: sess.decode_gop(staged),
         "exec_tables", "exec_tables_kernel"),
        ("one kernel-route decode_frame_any_device (graphics)",
         lambda: decode_frame_any_device(
             ctx.fi["uniform"]["graphics"], H, W, snappy="kernel",
             device=ctx.dev),
         "general_decode", "general_decode_kernel"),
    )
    device_ms = {}
    for label, fn, name, symbol in windows:
        fn()
        ctx.sync()
        with profile(activities=[activity.CPU, activity.CUDA]) as prof:
            fn()
            ctx.sync()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if not ev:
            print(f"phase 5 foreign profile ({label}): the profiler saw no "
                  f"device time [{ctx.card}]", flush=True)
            continue
        span = (max(e.time_range.end for e in ev)
                - min(e.time_range.start for e in ev)) / 1e3
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        hits = [e for e in ev if symbol in e.name]
        mine = sum(e.time_range.elapsed_us() for e in hits) / 1e3
        if hits:
            device_ms[name] = mine / len(hits)
        print(f"phase 5 foreign profile ({label}): {len(ev)} device ops, "
              f"device busy {busy:.3f} ms of a {span:.3f} ms window (idle "
              f"{100 * (1 - busy / span):.1f}%); {name} {mine:.3f} ms in "
              f"{len(hits)} launch(es), torch ops {busy - mine:.3f} ms "
              f"[{ctx.card}]", flush=True)
    return device_ms


def uneven_sizes(total, n):
    """n chunk sizes around total / n in whole 16-byte blocks, alternately
    larger and smaller by up to half."""
    S = total // n
    sizes = []
    for i in range(n // 2):
        d = G * (i % 5) * (S // (8 * G))
        sizes += [S + d, S - d]
    sizes[-1] += total - sum(sizes)
    return sizes


def nonuniform_frame(chunks):
    """A Hap Q frame laid out as hap.c never lays one out: an 8-byte
    top-level header; decode instructions holding the offset table first,
    an unknown section, then the compressor and size tables; chunks stored
    in reverse order. chunks: [(is_snappy, stored bytes)]."""
    from hap_tpu_torch.constants import (
        CHUNK_COMPRESSOR_NONE, CHUNK_COMPRESSOR_SNAPPY, COMPRESSOR_COMPLEX,
        FORMAT_YCOCG_DXT5, SECTION_CHUNK_COMPRESSOR_TABLE,
        SECTION_CHUNK_OFFSET_TABLE, SECTION_CHUNK_SIZE_TABLE,
        SECTION_DECODE_INSTRUCTIONS)
    from hap_tpu_torch.container.serialize import write_section_header as hdr

    comp = bytes(CHUNK_COMPRESSOR_SNAPPY if z else CHUNK_COMPRESSOR_NONE
                 for z, _ in chunks)
    sizes = b"".join(len(b).to_bytes(4, "little") for _, b in chunks)
    order = list(range(len(chunks)))[::-1]
    offsets, pos = {}, 0
    for i in order:
        offsets[i] = pos
        pos += len(chunks[i][1])
    table = b"".join(offsets[i].to_bytes(4, "little")
                     for i in range(len(chunks)))
    body = (hdr(4, len(table), SECTION_CHUNK_OFFSET_TABLE) + table
            + hdr(4, 3, 0x7F) + b"xyz"
            + hdr(4, len(comp), SECTION_CHUNK_COMPRESSOR_TABLE) + comp
            + hdr(4, len(sizes), SECTION_CHUNK_SIZE_TABLE) + sizes)
    top = (hdr(4, len(body), SECTION_DECODE_INSTRUCTIONS) + body
           + b"".join(chunks[i][1] for i in order))
    return hdr(8, len(top),
               (COMPRESSOR_COMPLEX << 4) | FORMAT_YCOCG_DXT5) + top


def handmade_streams():
    """[(stream, decoded bytes)]: literals with 1-5 byte headers, and
    copy-1, copy-2 and copy-4 elements with offsets 1-7 (overlapping
    copies) and longer."""
    from hap_tpu_torch.snappy.pyref import write_varint

    out = []
    for hlen, n in ((1, 40), (2, 200), (3, 5000), (4, 70000), (5, 300)):
        data = bytes((i * 7 + hlen) & 255 for i in range(n))
        m = n - 1
        head = (bytes([m << 2]) if hlen == 1 else
                bytes([(58 + hlen) << 2]) + m.to_bytes(hlen - 1, "little"))
        out.append((write_varint(n) + head + data, data))
    expect = bytearray(range(97, 105))
    st = bytearray([(len(expect) - 1) << 2]) + expect

    def copy(kind, off, ln):
        if kind == 1:
            st.extend([1 | ((ln - 4) << 2) | ((off >> 8) << 5), off & 255])
        else:
            st.append(kind | ((ln - 1) << 2))
            st.extend(off.to_bytes(2 if kind == 2 else 4, "little"))
        for _ in range(ln):
            expect.append(expect[-off])

    for off in range(1, 8):
        copy(1, off, 11)
        copy(2, off, 64)
        copy(3, off, 33)
    copy(1, 700, 9)
    copy(3, 760, 64)
    copy(2, 500, 1)
    out.append((write_varint(len(expect)) + bytes(st), bytes(expect)))
    return out


def corrupt_streams(good, S):
    """[(name, stream, out_len)] that a decoder must reject; the last three
    corrupt ``good``, a real stream of S bytes."""
    from hap_tpu_torch.snappy.pyref import write_varint as v

    lit4 = bytes([3 << 2]) + b"abcd"
    big = bytearray(good)
    pre = len(v(S))
    big[pre: pre + 5] = bytes([63 << 2, 0xFF, 0xFF, 0xFF, 0xFE])
    return [
        ("offset 0", v(8) + lit4 + bytes([2 | (3 << 2), 0, 0]), 8),
        ("offset > produced", v(8) + lit4 + bytes([2 | (3 << 2), 5, 0]), 8),
        ("copy past out_len", v(8) + lit4 + bytes([2 | (7 << 2), 4, 0]), 8),
        ("literal past the stream end", v(8) + bytes([7 << 2]) + b"abcd", 8),
        ("bad preamble", b"\xff" * 6 + b"aaaa", 4),
        ("preamble != out_len", v(9) + bytes([7 << 2]) + b"abcdefgh", 8),
        ("trailing bytes", v(4) + lit4 + b"\x00", 4),
        ("5-byte literal header, huge length",
         v(8) + bytes([63 << 2, 0xFF, 0xFF, 0xFF, 0xFF]) + b"abcdefgh", 8),
        ("literal of 2^31 - 9 bytes", v(64) + bytes([11 << 2]) + bytes(12)
         + bytes([63 << 2, 0xF6, 0xFF, 0xFF, 0x7F]) + bytes(40), 64),
        ("real stream, huge literal", bytes(big), S),
        ("real stream, truncated", good[:-1], S),
        ("real stream, trailing byte", good + b"\x00", S),
    ]


def stream_rows(torch, streams, out_lens, dev):
    """Streams -> kernel F's (C, B) rows, comp_len and out_len on dev."""
    import numpy as np

    B = max([len(s) for s in streams] + [1])
    rows = np.zeros((len(streams), B), np.uint8)
    for i, st in enumerate(streams):
        rows[i, :len(st)] = np.frombuffer(st, np.uint8)
    i32 = torch.int32
    return (torch.from_numpy(rows).to(dev),
            torch.tensor([len(st) for st in streams], dtype=i32, device=dev),
            torch.tensor(list(out_lens), dtype=i32, device=dev))


def foreign_inputs(ctx):
    """Host-side frames of the foreign path: per class the 64 chunk streams
    of the 4K payload, a hap.c-layout frame and a non-uniform frame; the
    8-frame graphics GOP; a corrupted frame."""
    import numpy as np

    from hap_tpu_torch.container.parse import parse_frame
    from hap_tpu_torch.container.serialize import serialize_texture
    from hap_tpu_torch.content import make_frame
    from hap_tpu_torch.kernels.layout import words_to_payload
    from hap_tpu_torch.pipeline.device_pipeline import encode_blocks
    from hap_tpu_torch.snappy import pyref

    torch, dev, S, cc = ctx.torch, ctx.dev, ctx.S, ctx.cc
    t0 = ctx.time.perf_counter()
    fi = {"payload": {}, "streams": {}, "uniform": {}, "nonuniform": {}}
    for cls in CLASSES:
        pay = ctx.inputs[cls]["payload"].cpu().numpy().tobytes()
        streams = [pyref.compress(pay[c * S:(c + 1) * S]) for c in range(cc)]
        fi["payload"][cls] = pay
        fi["streams"][cls] = streams
        fi["uniform"][cls] = serialize_texture(pay, True, cc,
                                               precompressed=streams)
        chunks, o = [], 0
        for k, n in enumerate(uneven_sizes(len(pay), cc)):
            part = pay[o:o + n]
            o += n
            st = pyref.compress(part) if k % 5 != 2 else part
            chunks.append((k % 5 != 2 and len(st) < n,
                           st if len(st) < n else part))
        fi["nonuniform"][cls] = nonuniform_frame(chunks)
    fi["gop_payloads"], fi["gop_streams"], fi["gop"] = [], [], []
    for k in range(FOREIGN_GOP):
        img = torch.from_numpy(make_frame("graphics", k, H, W)).to(dev)
        pay = words_to_payload(encode_blocks(img)).cpu().numpy().tobytes()
        streams = [pyref.compress(pay[c * S:(c + 1) * S]) for c in range(cc)]
        fi["gop_payloads"].append(pay)
        fi["gop_streams"].append(streams)
        fi["gop"].append(serialize_texture(pay, True, cc,
                                           precompressed=streams))
    # corrupted: the first element of graphics chunk 0 becomes a literal
    # whose 5-byte header claims ~4 GB
    bad = bytearray(fi["uniform"]["graphics"])
    tex = parse_frame(bytes(bad)).textures[0]
    ctx.check(tex.chunk_compressors[0] == 0x0B, "graphics chunk 0 is raw")
    a = int(tex.chunk_compressed_offsets[0]) + len(pyref.write_varint(S))
    bad[a:a + 5] = bytes([63 << 2, 0xFF, 0xFF, 0xFF, 0xFE])
    fi["corrupted"] = bytes(bad)
    build_s = ctx.time.perf_counter() - t0
    desc = []
    for cls in CLASSES:
        u = parse_frame(fi["uniform"][cls]).textures[0]
        nu = parse_frame(fi["nonuniform"][cls]).textures[0]
        desc.append(
            f"{cls}: hap.c layout {len(fi['uniform'][cls])} B "
            f"({int((u.chunk_compressors == 0x0B).sum())} of {cc} Snappy), "
            f"non-uniform {len(fi['nonuniform'][cls])} B "
            f"({int((nu.chunk_compressors == 0x0B).sum())} Snappy, chunk "
            f"sizes {int(nu.chunk_uncompressed_sizes.min())}-"
            f"{int(nu.chunk_uncompressed_sizes.max())})")
    print(f"phase 2 foreign inputs: {'; '.join(desc)}; graphics GOP of "
          f"{FOREIGN_GOP} frames {sum(map(len, fi['gop']))} B; built on the "
          f"host (pure-Python Snappy) in {build_s:.1f} s", flush=True)
    ctx.fi = fi
    return fi


def foreign_phase2(ctx):
    """Kernels F and G against their plain versions at 4K."""
    from hap_tpu_torch.snappy import pyref
    from hap_tpu_torch.snappy.exec_kernels import execute_op_tables
    from hap_tpu_torch.snappy.general_kernels import decode_any_streams
    from hap_tpu_torch.snappy.optable import pack_tables

    torch, dev, S, cc, check = ctx.torch, ctx.dev, ctx.S, ctx.cc, ctx.check
    fi = foreign_inputs(ctx)
    st = ctx.stats
    st["general_decode"] = {"err": 0, "plain_ms": [], "bytes": []}
    st["exec_tables"] = {"err": 0, "plain_ms": [], "bytes": []}
    ctx.f_in, ctx.g_in = {}, {}

    def run_f(streams, out_lens, S_max):
        rows = stream_rows(torch, streams, out_lens, dev)
        out, ok = decode_any_streams(*rows, S_max)
        rows_c = tuple(t.cpu() for t in rows)
        (out_p, ok_p), ms = ctx.host_ms(
            lambda: decode_any_streams(*rows_c, S_max))
        err = ctx.max_err(out.cpu(), out_p)
        st["general_decode"]["err"] = max(st["general_decode"]["err"], err)
        check(err == 0 and torch.equal(ok.cpu(), ok_p),
              "general_decode != plain")
        return rows, out_p, ok_p, ms

    def run_g(p, S_max):
        args = (p.ops.to(dev), p.n_ops.to(dev), p.lit.to(dev),
                p.out_len.to(dev))
        out = execute_op_tables(*args, S_max)
        out_p, ms = ctx.host_ms(lambda: execute_op_tables(
            p.ops, p.n_ops, p.lit, p.out_len, S_max))
        live = torch.arange(S_max)[None, :] < p.out_len[:, None]
        err = ctx.max_err(out.cpu()[live], out_p[live])
        st["exec_tables"]["err"] = max(st["exec_tables"]["err"], err)
        check(err == 0, "exec_tables != plain")
        return args, out_p, ms

    def g_bytes(p):
        return (8 * int(p.n_ops.sum()) + int(p.n_lit.sum())
                + int(p.out_len.sum()) + 12 * p.n_ops.shape[0])

    for cls in CLASSES:
        streams, pay = fi["streams"][cls], fi["payload"][cls]
        rows, out_p, ok_p, ms = run_f(streams, [S] * cc, S)
        check(bool(ok_p.all()) and out_p.numpy().tobytes() == pay,
              f"{cls}: general_decode does not decode the payload")
        st["general_decode"]["plain_ms"].append(ms)
        st["general_decode"]["bytes"].append(
            sum(map(len, streams)) + cc * S + 9 * cc)
        ctx.f_in[cls] = rows
        pieces = {}
        for pm in (128, 0):
            p = pack_tables(streams, [S] * cc, S_max=S, promote_max=pm)
            check(bool(p.ok.all()), f"{cls}: op-table compile rejected")
            args, out_p, ms = run_g(p, S)
            check(out_p.numpy().tobytes() == pay,
                  f"{cls}: exec_tables does not decode the payload")
            pieces[pm] = (int(p.n_ops.sum()), int(p.n_lit.sum()))
            if pm == 128:  # the route's default tables
                st["exec_tables"]["plain_ms"].append(ms)
                st["exec_tables"]["bytes"].append(g_bytes(p))
                ctx.g_in[cls] = args
        print(f"phase 2 foreign {cls}: general_decode and exec_tables equal "
              f"their plain versions on all {cc} streams "
              f"({sum(map(len, streams))} B) and decode the payload; tables "
              f"promote_max 128: {pieces[128][0]} pieces, {pieces[128][1]} "
              f"literal B; promote_max 0: {pieces[0][0]} pieces, "
              f"{pieces[0][1]} literal B [{ctx.card}]", flush=True)

    # one table launch over the N x C chunks of the graphics GOP
    streams = [x for sl in fi["gop_streams"] for x in sl]
    p = pack_tables(streams, [S] * len(streams), S_max=S)
    args, out_p, ms = run_g(p, S)
    check(out_p.numpy().tobytes() == b"".join(fi["gop_payloads"]),
          "GOP: exec_tables does not decode the payloads")
    ctx.g_gop = (args, g_bytes(p), ms)
    print(f"phase 2 foreign GOP: one exec_tables launch over "
          f"{len(streams)} chunks ({FOREIGN_GOP} frames, {int(p.n_ops.sum())} "
          f"pieces) equals its plain version and decodes all payloads "
          f"(plain {ms:.0f} ms) [{ctx.card}]", flush=True)

    # hand-made and hand-corrupted streams
    made = handmade_streams()
    _, out_p, ok_p, _ = run_f([m[0] for m in made], [len(m[1]) for m in made],
                              max(len(m[1]) for m in made))
    for i, (stream, data) in enumerate(made):
        check(bool(ok_p[i]) and out_p[i, :len(data)].numpy().tobytes() == data
              and pyref.decompress(stream, len(data)) == data,
              f"hand-made stream {i} does not decode")
    bad = corrupt_streams(fi["streams"]["graphics"][0], S)
    _, out_p, ok_p, _ = run_f([b[1] for b in bad], [b[2] for b in bad], S)
    for i, (name, stream, n) in enumerate(bad):
        check(not bool(ok_p[i]), f"corrupt stream not flagged: {name}")
        try:
            pyref.decompress(stream, n)
            check(False, f"pyref accepts the corrupt stream: {name}")
        except ValueError:
            pass
    print(f"phase 2 foreign streams: {len(made)} hand-made streams (1-5 byte "
          f"literal headers, copy-1/2/4, offsets 1-7) decode; {len(bad)} "
          f"corrupt streams ({', '.join(b[0] for b in bad)}) flagged not-ok "
          f"by general_decode and its plain version alike, as pyref rejects "
          f"them [{ctx.card}]", flush=True)


def foreign_phase3(ctx):
    """The foreign path end to end; returns F's and G's launch counts."""
    import numpy as np

    from hap_tpu_torch.pipeline.any_frame import (
        ForeignGopSession, decode_frame_any_device)
    from hap_tpu_torch.pipeline.device_pipeline import decode_blocks
    from hap_tpu_torch.snappy.exec_kernels import EXEC_TABLES
    from hap_tpu_torch.snappy.general_kernels import GENERAL_DECODE
    from hap_tpu_torch.snappy.rle_kernels import RLE_COMPACT, RLE_DECODE

    torch, dev, check, fi = ctx.torch, ctx.dev, ctx.check, ctx.fi

    def ref_pixels(pay):
        words = torch.from_numpy(np.frombuffer(pay, np.int32).copy()).to(dev)
        return decode_blocks(words, H, W)

    for k in (GENERAL_DECODE, EXEC_TABLES):
        k.launches = 0
    for cls in CLASSES:
        ref = ref_pixels(fi["payload"][cls])
        for layout in ("uniform", "nonuniform"):
            for route in ROUTES:
                pix, ok = decode_frame_any_device(
                    fi[layout][cls], H, W, snappy=route, device=dev)
                check(bool(ok) and torch.equal(pix, ref),
                      f"{cls} {layout} frame, {route} route: wrong decode")
    sess = ForeignGopSession(H, W, device=dev)
    staged = [sess.stage(f) for f in fi["gop"]]
    pix, ok = sess.decode_gop(staged)
    check(bool(ok.all()), "foreign GOP: ok is False")
    for k, pay in enumerate(fi["gop_payloads"]):
        check(torch.equal(pix[k], ref_pixels(pay)),
              f"foreign GOP frame {k}: wrong pixels")
    for route in ROUTES:
        _, ok = decode_frame_any_device(fi["corrupted"], H, W, snappy=route,
                                        device=dev)
        check(not bool(ok), f"corrupted frame not flagged on {route} route")
    ctx.sync()
    counts = {"general_decode": GENERAL_DECODE.launches,
              "exec_tables": EXEC_TABLES.launches}
    check(all(v > 0 for v in counts.values()),
          f"a kernel was not launched on the foreign path: {counts}")
    print(f"phase 3 foreign: hap.c-layout and non-uniform 4K frames of all "
          f"three classes decode on both routes to the pixels of "
          f"decode_blocks of their payloads; the {FOREIGN_GOP}-frame graphics "
          f"GOP through ForeignGopSession likewise; the corrupted frame "
          f"flagged on both routes; launches {json.dumps(counts)} "
          f"[{ctx.card}]", flush=True)
    ctx.f_session = (sess, staged)
    return counts


def foreign_phase4(ctx):
    """Times of the foreign path and of kernels F and G."""
    from hap_tpu_torch.pipeline.any_frame import decode_frame_any_device
    from hap_tpu_torch.snappy.exec_kernels import execute_op_tables
    from hap_tpu_torch.snappy.general_kernels import decode_any_streams

    fi, dev, S = ctx.fi, ctx.dev, ctx.S
    for route, iters in (("table", 3), ("kernel", TIMED_ITERS)):
        ms = [ctx.cuda_ms(lambda: decode_frame_any_device(
            fi["uniform"][c], H, W, snappy=route, device=dev), iters)
            for c in CLASSES]
        print(f"phase 4 foreign decode_frame_any_device, {route} route: "
              + ", ".join(f"{c} {m:.3f} ms" for c, m in zip(CLASSES, ms))
              + f" per frame (hap.c layout; host parse"
              + (" and op-table compile" if route == "table" else "")
              + f" included) [{ctx.card}]", flush=True)
    sess, staged = ctx.f_session
    split = {k: statistics.mean(s.stage_ms[k] for s in staged)
             for k in ("parse", "compile", "upload")}
    gop_ms = ctx.cuda_ms(lambda: sess.decode_gop(staged)) / len(staged)
    print(f"phase 4 foreign GOP: stage host ms per frame "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; decode_gop {gop_ms:.3f} ms per frame over {len(staged)} "
          f"frames [{ctx.card}]", flush=True)
    per = {"general_decode": [], "exec_tables": []}
    for cls in CLASSES:
        per["general_decode"].append(ctx.cuda_ms(
            lambda: decode_any_streams(*ctx.f_in[cls], S)))
        per["exec_tables"].append(ctx.cuda_ms(
            lambda: execute_op_tables(*ctx.g_in[cls], S)))
    args, nbytes, plain = ctx.g_gop
    gop_launch = ctx.cuda_ms(lambda: execute_op_tables(*args, S))
    print(f"phase 4 foreign exec_tables GOP launch ({args[0].shape[0]} "
          f"chunks): {gop_launch:.4f} ms; bound {nbytes / ctx.hbm * 1e3:.4f} "
          f"ms; plain (host CPU) {plain:.0f} ms [{ctx.card}]", flush=True)
    return per


# ---------------------------------------------------------------------------
# the RLE profile (HAP_TPU_DEVICE_LZ=0): kernels E (rle_compact) and D(ii)
# (rle_decode_from_frame), pipeline/session.py
# ---------------------------------------------------------------------------

RLE_SESSION_BATCH = 3  # the three classes, one host sync


def rle_rows(rng, S, C):
    """(C, S) payloads that force every flavor of the profile: flat rows
    (seeded unit 0, copies, a tail copy or a seeded tail), periodic rows
    broken by a literal unit whose last G bytes the next unit copies,
    rows of flat and random units mixed, and random rows (literals)."""
    import numpy as np

    U = 4096
    rows = np.empty((C, S), np.uint8)
    for c in range(C):
        pat = rng.integers(0, 256, G, dtype=np.uint8)
        r = np.tile(pat, S // G)
        kind = c % 4
        n_units = -(-S // U)
        if kind == 1 and S > U:  # a literal unit mid-chunk
            u = 1 + c % max(1, n_units - 2)
            r[u * U: min(S, (u + 1) * U) - G] = rng.integers(
                0, 256, min(S, (u + 1) * U) - G - u * U)
        elif kind == 1:  # a literal seed group, then the run
            r[:G] = rng.integers(0, 256, G)
        elif kind == 2:  # flat and random units mixed
            for u in range(n_units):
                if rng.integers(0, 2):
                    a, b = u * U, min(S, (u + 1) * U)
                    r[a:b] = rng.integers(0, 256, b - a)
        elif kind == 3:
            r = rng.integers(0, 256, S, dtype=np.uint8)
        rows[c] = r
    return rows


def rle_phase2(ctx):
    """Kernels E and D(ii) against their plain versions: the three classes'
    4K payloads, synthetic payloads forcing every flavor at 4K, an S <
    4096 shape (seeded tail) and a shape with no tail, and corrupted
    streams."""
    import numpy as np

    from hap_tpu_torch.snappy import device as rle
    from hap_tpu_torch.snappy.rle_kernels import (
        compact_streams_from_data, decode_rle_streams_from_frame)
    from hap_tpu_torch.snappy.stream_kernels import raw_chunks_from_frame

    torch, dev, check = ctx.torch, ctx.dev, ctx.check
    st = ctx.stats
    st["rle_compact"] = {"err": 0, "plain_ms": [], "bytes": []}
    st["rle_decode_from_frame"] = {"err": 0, "plain_ms": [], "bytes": []}
    ctx.rle_in = {}

    def e_bytes(sizes, p):
        lit = sizes == p.emit_max
        t = p.n_full < sizes.shape[1]
        if t:
            lit[:, -1] = sizes[:, -1] == p.tail_lit_size
        unit_len = torch.full(sizes.shape, p.U)
        if t:
            unit_len[:, -1] = p.tail
        seeded = (sizes == p.seed_size)[:, 0] if p.n_full else \
            sizes[:, 0] == p.tail_seed_size
        return (int(unit_len[lit].sum()) + G * int(seeded.sum())
                + 8 * sizes.numel() + sizes.shape[0] * p.bound)

    def run(data, S, label, record=False):
        """E and D(ii) (after D) on device and plain; returns the decode
        tables and the plain E streams."""
        p = rle.profile(S, G)
        C = data.shape[0]
        sizes = rle._unit_sizes(data, S, G)
        pos, clen = rle._positions(sizes, len(p.pre))
        e_args = (data, pos, sizes, S, G, p.bound)
        comp = compact_streams_from_data(*e_args)
        e_args_c = tuple(map(ctx_cpu, e_args))
        comp_p, ms = ctx.host_ms(lambda: compact_streams_from_data(*e_args_c))
        err = ctx.max_err(comp.cpu(), comp_p)
        st["rle_compact"]["err"] = max(st["rle_compact"]["err"], err)
        check(err == 0, f"{label}: rle_compact != plain")
        comp[:, :len(p.pre)] = torch.from_numpy(p.pre).to(dev)
        comp_p[:, :len(p.pre)] = torch.from_numpy(p.pre)
        tables = (comp.reshape(-1),
                  torch.arange(C, dtype=torch.int32, device=dev) * p.bound,
                  clen, torch.ones(C, dtype=torch.bool, device=dev))
        out, ok, out_p, ok_p, d_ms = rle_decode_both(tables, S)
        check(bool(ok_p.all()) and torch.equal(out_p, data.cpu()),
              f"{label}: the streams do not decode to the payload")
        if record:
            st["rle_compact"]["plain_ms"].append(ms)
            st["rle_compact"]["bytes"].append(e_bytes(sizes.cpu(), p))
            st["rle_decode_from_frame"]["plain_ms"].append(d_ms)
            st["rle_decode_from_frame"]["bytes"].append(
                int(clen.clamp(max=p.bound).sum()) + C * S + 10 * C)
        flavors = sorted(set(sizes.flatten().tolist()))
        return (e_args, tables), comp_p, flavors, clen.cpu()

    def ctx_cpu(t):
        return t.cpu() if torch.is_tensor(t) else t

    def rle_decode_both(tables, S):
        out, ok = raw_chunks_from_frame(*tables, S)
        decode_rle_streams_from_frame(*tables, S, G, out, ok)
        tables_c = tuple(t.cpu() for t in tables)

        def plain():
            o, k = raw_chunks_from_frame(*tables_c, S)
            decode_rle_streams_from_frame(*tables_c, S, G, o, k)
            return o, k

        (out_p, ok_p), ms = ctx.host_ms(plain)
        err = ctx.max_err(out.cpu(), out_p)
        st["rle_decode_from_frame"]["err"] = max(
            st["rle_decode_from_frame"]["err"], err)
        check(err == 0 and torch.equal(ok.cpu(), ok_p),
              "rle_decode_from_frame != plain")
        return out, ok, out_p, ok_p, ms

    S, cc = ctx.S, ctx.cc
    for cls in CLASSES:
        chunks = ctx.inputs[cls]["chunks"]
        args, _, flavors, clen = run(chunks, S, cls, record=True)
        ctx.rle_in[cls] = args
        n_snappy = int((clen < S).sum())
        print(f"phase 2 rle {cls}: rle_compact and rle_decode_from_frame "
              f"equal their plain versions on all {cc} chunks; {n_snappy} "
              f"streams shorter than the chunk; unit sizes {flavors} "
              f"[{ctx.card}]", flush=True)

    rng = np.random.default_rng(7)
    shapes = ((S, cc, "4K synthetic"), (2048, cc, "S=2048 (tail only)"),
              (131072, cc, "S=131072 (no tail)"))
    for S2, C2, label in shapes:
        data = torch.from_numpy(rle_rows(rng, S2, C2)).to(dev)
        (_, tables), comp_p, flavors, _ = run(data, S2, label)
        p = rle.profile(S2, G)
        want = {p.emit_max, len(p.copy_pat), p.seed_size} if p.n_full else \
            {p.tail_lit_size, p.tail_seed_size}
        if p.tail and p.n_full:
            want |= {p.tail_lit_size, len(p.tail_copy_pat)}
        check(want <= set(flavors), f"{label}: flavors {flavors} lack "
              f"{sorted(want - set(flavors))}")
        print(f"phase 2 rle {label}: E and D(ii) equal their plain "
              f"versions on {C2} chunks of {S2} B; unit sizes {flavors} "
              f"(every flavor) [{ctx.card}]", flush=True)
        if S2 == S:
            synth = (data, comp_p, tables)

    # corrupted streams, read as a frame: chunk c at c * bound
    data, comp_p, (flat, cpos, clen, cis) = synth
    p = rle.profile(S, G)
    P = len(p.pre)
    bad = flat.clone().reshape(cc, p.bound)
    sizes = clen.clone()
    is_comp = cis.clone()
    runs = [c for c in range(cc) if c % 4 == 0]  # flat rows
    cases = [
        ("wrong preamble", runs[0], lambda r: (0, 1)),
        ("seed tag flipped", runs[1], lambda r: (P, 4)),
        ("copy tag flipped", runs[2], lambda r: (P + p.seed_size, 8)),
        ("copy pattern byte", runs[3], lambda r: (P + p.seed_size + 4, 1)),
        ("seed pattern byte", runs[4], lambda r: (P + 1 + G + 1, 2)),
        ("tail copy tag", runs[5], lambda r: (int(clen[r]) - 3, 8)),
    ]
    for _, r, f in cases:
        at, x = f(r)
        bad[r, at] ^= x
    sizes[runs[6]] += 1
    sizes[runs[7]] -= 1
    is_comp[runs[8]] = False  # stored raw, but its size entry is not S
    flagged = [r for _, r, _ in cases] + runs[6:9]
    names = [n for n, _, _ in cases] + ["comp_len + 1", "comp_len - 1",
                                        "raw chunk, size != S"]
    _, ok, _, ok_p, _ = rle_decode_both(
        (bad.reshape(-1), cpos, sizes, is_comp), S)
    want = torch.ones(cc, dtype=torch.bool)
    want[flagged] = False
    check(torch.equal(ok_p, want), f"corrupted rle streams not flagged "
          f"exactly: not-ok {torch.nonzero(~ok_p).flatten().tolist()}, "
          f"corrupted {flagged}")
    print(f"phase 2 rle corrupted streams: {', '.join(names)} flagged "
          f"not-ok by D(ii) (and D) and their plain versions alike; the "
          f"{cc - len(flagged)} other chunks ok [{ctx.card}]", flush=True)


def rle_phase3(ctx):
    """The RLE profile end to end through DeviceSession; returns E's and
    D(ii)'s launch counts."""
    import numpy as np

    from hap_tpu_torch.container.parse import parse_frame
    from hap_tpu_torch.pipeline.session import DECODE_REASONS, DeviceSession
    from hap_tpu_torch.snappy import pyref
    from hap_tpu_torch.snappy.lz_kernels import LZ_DECODE, LZ_EMIT
    from hap_tpu_torch.snappy.rle_kernels import RLE_COMPACT, RLE_DECODE
    from hap_tpu_torch.snappy.stream_kernels import RAW_CHUNKS, STITCH

    torch, check = ctx.torch, ctx.check
    frames = np.stack([ctx.imgs[c].cpu().numpy() for c in CLASSES])
    all_k = {"lz_emit": LZ_EMIT, "lz_decode_from_frame": LZ_DECODE,
             "stitch": STITCH, "raw_chunks_from_frame": RAW_CHUNKS,
             "rle_compact": RLE_COMPACT,
             "rle_decode_from_frame": RLE_DECODE}
    n = len(CLASSES)
    with device_lz("0"):
        sess = DeviceSession(H, W, "hap_q", CHUNKS, batch=RLE_SESSION_BATCH,
                             device=ctx.dev)
        for k in all_k.values():
            k.launches = 0
        out, flen, ok = sess.roundtrip(frames)
        encoded, stats = sess.encode_with_stats(frames)
        fmax = max(map(len, encoded))
        padded = np.zeros((n, fmax), np.uint8)
        for i, fb in enumerate(encoded):
            padded[i, :len(fb)] = np.frombuffer(fb, np.uint8)
        img, ok_r, reasons = sess.decode_with_reasons(padded)
        ctx.sync()
        counts = {name: k.launches for name, k in all_k.items()}
    want = {"lz_emit": 0, "lz_decode_from_frame": 0, "stitch": 2 * n,
            "raw_chunks_from_frame": 2 * n, "rle_compact": 2 * n,
            "rle_decode_from_frame": 2 * n}
    check(counts == want, f"rle session launches {counts}, expected {want}")
    check(bool(ok.all()) and bool(ok_r.all()), "rle session: ok is False")
    check(all(all(all(v) for v in d.values()) and set(d) ==
              set(DECODE_REASONS) for d in reasons), "rle reasons not all ok")
    desc = []
    for i, cls in enumerate(CLASSES):
        lz = ctx.lz_out[cls].cpu()
        check(torch.equal(torch.from_numpy(out[i]), lz)
              and torch.equal(torch.from_numpy(img[i]), lz),
              f"{cls}: RLE pixels != LZ pixels")
        fb = encoded[i]
        check(len(fb) == int(flen[i]), f"{cls}: frame length differs")
        tex = parse_frame(fb).textures[0]
        payload = ctx.inputs[cls]["payload"].cpu().numpy().tobytes()
        parts = []
        for c in range(tex.chunk_count):
            a = int(tex.chunk_compressed_offsets[c])
            blob = fb[a: a + int(tex.chunk_compressed_sizes[c])]
            if tex.chunk_compressors[c] == 0x0B:
                blob = pyref.decompress(blob, int(
                    tex.chunk_uncompressed_sizes[c]))
            parts.append(blob)
        check(b"".join(parts) == payload,
              f"{cls}: RLE frame does not decompress to its payload")
        s = stats[i]
        raw = tex.stored_compressor == 0xA
        snappy = 0 if raw else int((tex.chunk_compressors == 0x0B).sum())
        check(s.frame_bytes == len(fb) and s.input_bytes == len(payload)
              and s.whole_frame_raw_sections == int(raw)
              and s.snappy_chunks == snappy
              and s.raw_chunk_fallbacks == (0 if raw else CHUNKS - snappy)
              and s.chunk_count == CHUNKS,
              f"{cls}: stats {s} disagree with the frame")
        if cls == "natural":
            check(not raw and snappy > 0, "natural RLE frame has no Snappy "
                  "chunks")
        else:
            check(raw and len(fb) == 4 + len(payload),
                  f"{cls}: RLE frame is not stored whole-frame raw")
        ctx.rle_frames[cls] = fb
        desc.append(f"{cls} {len(fb)} B, "
                    + ("whole-frame raw" if raw else
                       f"complex, {snappy} of {CHUNKS} chunks Snappy"))
    print(f"phase 3 rle (HAP_TPU_DEVICE_LZ=0): DeviceSession roundtrip, "
          f"encode_with_stats and decode_with_reasons over the three 4K "
          f"frames: ok everywhere, pixels == the LZ profile's, frames "
          f"decompress on the host to their payloads, stats and reasons "
          f"match the frames; {'; '.join(desc)}; launches "
          f"{json.dumps(counts)} [{ctx.card}]", flush=True)

    # the session once more on the LZ default
    for k in all_k.values():
        k.launches = 0
    sess = DeviceSession(H, W, "hap_q", CHUNKS, batch=RLE_SESSION_BATCH,
                         device=ctx.dev)
    out, flen, ok = sess.roundtrip(frames)
    counts_lz = {name: k.launches for name, k in all_k.items()}
    check(bool(ok.all()) and all(torch.equal(torch.from_numpy(out[i]),
                                             ctx.lz_out[c].cpu())
                                 for i, c in enumerate(CLASSES)),
          "LZ session roundtrip != roundtrip_pipeline")
    check(counts_lz["lz_emit"] == n and counts_lz["rle_compact"] == 0
          and counts_lz["lz_decode_from_frame"] == n
          and counts_lz["rle_decode_from_frame"] == 0,
          f"LZ session launches {counts_lz}")
    print(f"phase 3 session (LZ default): roundtrip of the three frames ok, "
          f"pixels == roundtrip_pipeline's; launches {json.dumps(counts_lz)} "
          f"[{ctx.card}]", flush=True)
    ctx.rle_session = (sess, frames)
    return {"rle_compact": counts["rle_compact"],
            "rle_decode_from_frame": counts["rle_decode_from_frame"]}


def rle_phase4(ctx):
    """Times of the RLE profile: E and D(ii) per launch, the RLE
    roundtrip per frame, and the session per batch on both profiles."""
    from hap_tpu_torch.pipeline.device_pipeline import roundtrip_pipeline
    from hap_tpu_torch.pipeline.session import DeviceSession
    from hap_tpu_torch.snappy.rle_kernels import (
        compact_streams_from_data, decode_rle_streams_from_frame)

    torch, dev = ctx.torch, ctx.dev
    per = {"rle_compact": [], "rle_decode_from_frame": []}
    for cls in CLASSES:
        e_args, tables = ctx.rle_in[cls]
        per["rle_compact"].append(ctx.cuda_ms(
            lambda: compact_streams_from_data(*e_args)))
        out = torch.empty((ctx.cc, ctx.S), dtype=torch.uint8, device=dev)
        ok = torch.empty(ctx.cc, dtype=torch.bool, device=dev)
        per["rle_decode_from_frame"].append(ctx.cuda_ms(
            lambda: decode_rle_streams_from_frame(*tables, ctx.S, G, out,
                                                  ok)))
    sess_lz, frames = ctx.rle_session

    def batch_ms(sess):
        sess.roundtrip(frames)  # warm-up
        ts = []
        for _ in range(3):
            t = ctx.time.perf_counter()
            sess.roundtrip(frames)
            ts.append((ctx.time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    with device_lz("0"):
        rt = [ctx.cuda_ms(lambda: roundtrip_pipeline(
            ctx.imgs[c], "hap_q", CHUNKS, device=dev)) for c in CLASSES]
        sess = DeviceSession(H, W, "hap_q", CHUNKS, batch=RLE_SESSION_BATCH,
                             device=dev)
        rle_batch = batch_ms(sess)
    lz_batch = batch_ms(sess_lz)
    print(f"phase 4 rle roundtrip (HAP_TPU_DEVICE_LZ=0): " + ", ".join(
        f"{c} {m:.3f} ms" for c, m in zip(CLASSES, rt))
        + f"; median {statistics.median(rt):.3f} ms/frame [{ctx.card}]",
        flush=True)
    print(f"phase 4 DeviceSession roundtrip of a {len(frames)}-frame batch "
          f"(host clock, pixels in and out, one sync): RLE {rle_batch:.1f} "
          f"ms ({rle_batch / len(frames):.1f} ms/frame), LZ {lz_batch:.1f} "
          f"ms ({lz_batch / len(frames):.1f} ms/frame) [{ctx.card}]",
          flush=True)
    return per


def rle_profile(ctx, profile, activity):
    """Device busy and idle share of one RLE roundtrip (natural), and the
    device time of E and D(ii) per launch on the classes' inputs."""
    from hap_tpu_torch.pipeline.device_pipeline import roundtrip_pipeline
    from hap_tpu_torch.snappy.rle_kernels import (
        compact_streams_from_data, decode_rle_streams_from_frame)

    torch = ctx.torch
    with device_lz("0"):
        roundtrip_pipeline(ctx.imgs["natural"], "hap_q", CHUNKS,
                           device=ctx.dev)
        ctx.sync()
        with profile(activities=[activity.CPU, activity.CUDA]) as prof:
            roundtrip_pipeline(ctx.imgs["natural"], "hap_q", CHUNKS,
                               device=ctx.dev)
            ctx.sync()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if ev:
        span = (max(e.time_range.end for e in ev)
                - min(e.time_range.start for e in ev)) / 1e3
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        mine = {s: sum(e.time_range.elapsed_us() for e in ev
                       if s in e.name) / 1e3
                for s in ("rle_compact_kernel", "rle_decode_kernel")}
        print(f"phase 5 rle profile (one RLE roundtrip, natural): {len(ev)} "
              f"device ops, device busy {busy:.3f} ms of a {span:.3f} ms "
              f"window (idle {100 * (1 - busy / span):.1f}%); E "
              f"{mine['rle_compact_kernel']:.3f} ms, D(ii) "
              f"{mine['rle_decode_kernel']:.3f} ms, torch ops and B, D "
              f"{busy - sum(mine.values()):.3f} ms [{ctx.card}]", flush=True)
    else:
        print(f"phase 5 rle profile: the profiler saw no device time "
              f"[{ctx.card}]", flush=True)
    with profile(activities=[activity.CPU, activity.CUDA]) as prof:
        for cls in CLASSES:
            e_args, tables = ctx.rle_in[cls]
            compact_streams_from_data(*e_args)
            out = torch.empty((ctx.cc, ctx.S), dtype=torch.uint8,
                              device=ctx.dev)
            ok = torch.empty(ctx.cc, dtype=torch.bool, device=ctx.dev)
            decode_rle_streams_from_frame(*tables, ctx.S, G, out, ok)
        ctx.sync()
    device_ms = {}
    for name, symbol in (("rle_compact", "rle_compact_kernel"),
                         ("rle_decode_from_frame", "rle_decode_kernel")):
        hits = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and symbol in e.name]
        if hits:
            device_ms[name] = sum(hits) / 1e3 / len(hits)
    return device_ms


@contextlib.contextmanager
def device_lz(value):
    """HAP_TPU_DEVICE_LZ set to ``value`` inside the block, restored
    after."""
    old = os.environ.get("HAP_TPU_DEVICE_LZ")
    os.environ["HAP_TPU_DEVICE_LZ"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["HAP_TPU_DEVICE_LZ"]
        else:
            os.environ["HAP_TPU_DEVICE_LZ"] = old


if __name__ == "__main__":
    sys.exit(main())
