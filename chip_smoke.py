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
     per launch (CUDA events, synchronised each iteration).
Then one JSON line with the kernels' numbers and, last, the result line.
Exits nonzero on any failure; without CUDA (or outside a checkout) it
exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

H, W, CHUNKS = 2160, 3840, 64
CLASSES = ("natural", "graphics", "noise")
G = 16
TIMED_ITERS = 10


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
    for src, rep in sorted(reports.items()):
        for ln in rep.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {src}: {ln.strip()}", file=sys.stderr)
    print(f"phase 1 build: {len(reports)} CUDA sources compiled in "
          f"{build_s:.1f} s [{card}]", flush=True)

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

        args, flen = _stitch_inputs(payload, comp, plan.comp_len, cc,
                                    FORMAT_YCOCG_DXT5, G)         # B
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
        print(f"phase 3 {cls}: roundtrip ok, frame {int(flen)} B "
              f"({tex.chunk_count} chunks, "
              f"{int((tex.chunk_compressors == 0x0B).sum())} Snappy) parses "
              f"and decompresses on the host, decode == CPU decode, PSNR "
              f"{psnr[cls]:.3f} dB, launches {counts} [{card}]", flush=True)
    print(f"phase 3 kernels: launches on the main path over the three frames "
          f"{json.dumps(launches)} [{card}]", flush=True)

    # ---- phase 4: times -------------------------------------------------------
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

    rows = []
    for name in kernels:
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


if __name__ == "__main__":
    sys.exit(main())
