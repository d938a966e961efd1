#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py            # from the repository root

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: compile ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for sm_90a.
3. Kernels: launch K1 (pooled lookup), K2 (dot interaction), K5 (row
   gather) and K6 (dequantizing gather, int8 and f16) at the served
   shapes and hold each against its plain PyTorch version on the card;
   time kernel, plain version and one library call with CUDA events.
4. Bundle: write a full-width ``dlrm-criteo`` serving bundle (26 tables at
   D=128, 13 dense features, bottom MLP 512-256-128, top MLP
   1024-1024-512-256-1) with the port's own writer. The one cut: each
   table's vocabulary is capped at ``RUN.vocab_cap`` rows.
5. Serve: rebuild the server from ``ps.json`` on ``cuda`` and push
   batch-1024 Zipf requests through ``submit`` on the stream engine, once
   with an f32 and once with an int8 L1 payload; check the predictions
   against the plain path (pooled rows straight from the PDB, dense net
   with the plain ops) and that the kernels' launch counters rose.
6. One JSON line of per-kernel numbers, then the device line last.

Needs ``torch.cuda.is_available()`` and the package under ``src/``; with
either missing it prints no result and exits 2.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
#: probability tolerance of the served bf16 DLRM against the plain path
#: (the bound the reference holds its own server to); int8 payloads add
#: quantization error, bounded as the reference's launcher bounds it
SERVE_TOL = {"f32": 2e-2, "int8": 1e-1}
#: the run: vocabulary cap per table (the one cut), L1 rows per table,
#: request batch, warm-up and measured requests, seed
RUN = types.SimpleNamespace(vocab_cap=1 << 20, cache_capacity=131072,
                            batch=1024, warmup=4, requests=16, seed=0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 50) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph
    and replayed, so the host's launch cost (Python, ctypes, allocation)
    is out of the measurement."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, iters=10) / reps


def zipf_ids(rng, vocab: int, size, a: float = 1.1):
    """Frequency-sorted bounded-Zipf draw on [0, vocab) (the reference's
    synthetic-data distribution)."""
    import numpy as np
    u = rng.random(size)
    x = (u * ((vocab + 1.0) ** (1 - a) - 1.0) + 1.0) ** (1 / (1 - a))
    return np.clip(np.floor(x).astype(np.int64) - 1, 0, vocab - 1)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(args, dev):
    import numpy as np
    import torch
    from repro_torch.kernels import dot_interaction as k2
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.kernels import hps_gather as k56
    from repro_torch.core.hps.payload_store import quantize_rows

    g = torch.Generator(device="cpu").manual_seed(args.seed)
    B, D, C, F = args.batch, 128, args.cache_capacity, 27
    P = F * (F - 1) // 2
    rows_f32 = (torch.randn((C, D), generator=g) * 0.3)
    table = rows_f32.to(dev)
    slots = torch.randint(0, C, (B,), generator=g,
                          dtype=torch.int32).to(dev)
    q_np, sc_np = quantize_rows(rows_f32.numpy(), "int8")
    q8, sc8 = torch.from_numpy(q_np).to(dev), torch.from_numpy(sc_np).to(dev)
    h16 = rows_f32.to(torch.float16).to(dev)
    sc16 = (torch.rand((C,), generator=g) + 0.5).to(dev)
    x = torch.cat([torch.randn((B, 1, D), generator=g),
                   torch.randn((B, F - 1, D), generator=g) * 0.3], 1)
    x = x.to(torch.bfloat16).float().to(dev).contiguous()
    li, lj = torch.tril_indices(F, F, -1, device=dev)
    out, device = {}, {}

    def record(name, source, replaces, got, want, exact, tol, fn, plain,
               lib, nbytes, flops):
        err = (got - want).abs().max().item()
        if exact:
            check(torch.equal(got, want), f"{name}: not bit-exact "
                  f"(max abs err {err})")
        else:
            check(torch.allclose(got, want, rtol=tol, atol=tol),
                  f"{name}: max abs err {err} above {tol}")
        bms, by = bound_ms(nbytes, flops)
        out[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": time_ms(fn), "plain_ms": time_ms(plain),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lib) if lib is not None else None}
        device[name] = graph_ms(fn)

    # K1 at the served shape: f32 L1 payload [C, D], one id per table row
    rows = slots.view(B, 1)
    record("lookup_fwd", "src/repro_torch/csrc/embedding_lookup.cu",
           "src/repro/kernels/embedding_lookup.py:67",
           k1.lookup_fwd(table, rows), k1.lookup_fwd_plain(table, rows),
           True, 0.0, lambda: k1.lookup_fwd(table, rows),
           lambda: k1.lookup_fwd_plain(table, rows),
           lambda: table.index_select(0, slots).view(B, 1, D).sum(1),
           B * D * 4 + B * 4 + B * D * 4, B * D)
    # K1 off the served shape: bf16 table, H=3 with pads and duplicates
    multi = torch.randint(-1, 64, (B, 3), generator=g,
                          dtype=torch.int32).to(dev)
    tb = table.to(torch.bfloat16)
    got, want = k1.lookup_fwd(tb, multi), k1.lookup_fwd_plain(tb, multi)
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          "lookup_fwd bf16 H=3: above 1e-6")

    # K5: the L1 row read of DeviceEmbeddingCache.query
    holes = slots.clone()
    holes[::7] = -1
    record("gather_rows", "src/repro_torch/csrc/hps_gather.cu",
           "src/repro/kernels/hps_gather.py:54",
           k56.gather_rows(table, holes), k56.gather_rows_plain(table, holes),
           True, 0.0, lambda: k56.gather_rows(table, slots),
           lambda: k56.gather_rows_plain(table, slots),
           lambda: table.index_select(0, slots),
           B * D * 4 + B * 4 + B * D * 4, 0)

    # K6: the int8 L1 pooled read (and the f16 payload variant)
    got16 = k56.dequant_gather_rows(h16, sc16, holes)
    want16 = k56.dequant_gather_rows_plain(h16, sc16, holes)
    check(torch.equal(got16, want16), "dequant_gather_rows f16: not exact")
    record("dequant_gather_rows", "src/repro_torch/csrc/hps_gather.cu",
           "src/repro/kernels/hps_gather.py:98",
           k56.dequant_gather_rows(q8, sc8, holes),
           k56.dequant_gather_rows_plain(q8, sc8, holes), True, 0.0,
           lambda: k56.dequant_gather_rows(q8, sc8, slots),
           lambda: k56.dequant_gather_rows_plain(q8, sc8, slots),
           lambda: q8.index_select(0, slots).float()
           * sc8.index_select(0, slots)[:, None],
           B * D * 1 + B * 4 + B * 4 + B * D * 4, B * D)

    # K2: DLRM's interaction at F = 26 tables + 1, D = 128
    record("interaction_fwd", "src/repro_torch/csrc/dot_interaction.cu",
           "src/repro/kernels/dot_interaction.py:55",
           k2.interaction_fwd(x), k2.interaction_fwd_plain(x), False, 1e-5,
           lambda: k2.interaction_fwd(x),
           lambda: k2.interaction_fwd_plain(x),
           lambda: torch.bmm(x, x.transpose(1, 2))[:, li, lj],
           B * F * D * 4 + B * P * 4, 2 * B * P * D)
    xs = torch.randn((5, 4, 16), generator=g).to(dev)
    check(torch.allclose(k2.interaction_fwd(xs, self_interaction=True),
                         k2.interaction_fwd_plain(xs, self_interaction=True),
                         rtol=1e-5, atol=1e-5),
          "interaction_fwd self_interaction: above 1e-5")
    for rec in out.values():
        print(f"kernel {rec['name']}: {rec['ms']:.4f} ms (bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
              f"ms), max abs err {rec['max_abs_err']:.3g}; device time "
              f"{device[rec['name']]:.4f} ms (CUDA graph replay)")
    return out


# ---------------------------------------------------------------------------
# phases 4-5: full-width bundle, then serve it
# ---------------------------------------------------------------------------

def write_full_bundle(args, bundle_dir, dev):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.api import dlrm_graph
    from repro_torch.configs.registry import dlrm_criteo
    from repro_torch.core.hps.persistent_db import PersistentDB
    from repro_torch.models.recsys.model import RecsysModel
    from repro_torch.serve.server import write_bundle

    cfg = dataclasses.replace(dlrm_criteo, tables=tuple(
        dataclasses.replace(t, vocab_size=min(t.vocab_size, args.vocab_cap))
        for t in dlrm_criteo.tables))
    full_rows = sum(t.vocab_size for t in dlrm_criteo.tables)
    rows = sum(t.vocab_size for t in cfg.tables)
    print(f"reduced: vocabulary capped at {args.vocab_cap} rows per table: "
          f"{rows} rows ({rows * 128 * 4 / 1e9:.1f} GB f32) instead of "
          f"{full_rows} ({full_rows * 128 * 4 / 1e9:.1f} GB); widths, 26 "
          f"tables, hotness and both MLPs as published")
    t0 = time.perf_counter()
    pdb = PersistentDB(os.path.join(bundle_dir, "pdb"))
    rng = np.random.default_rng(args.seed)
    chunk = 1 << 18
    for t in cfg.tables:
        pdb.create_table(cfg.name, t.name, t.vocab_size, t.dim)
        for lo in range(0, t.vocab_size, chunk):
            hi = min(t.vocab_size, lo + chunk)
            block = rng.standard_normal((hi - lo, t.dim), dtype=np.float32)
            pdb.upsert(cfg.name, t.name, np.arange(lo, hi), block * 0.3)
    pdb.flush()
    model = RecsysModel(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(args.seed))
    write_bundle(bundle_dir, dlrm_graph(cfg), params,
                 cache_capacity=args.cache_capacity, max_batch=args.batch)
    print(f"bundle: {len(cfg.tables)} tables written in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, pdb, params


def make_requests(args, cfg, n, stream):
    import numpy as np
    rng = np.random.default_rng((args.seed, stream))
    reqs = []
    for _ in range(n):
        dense = rng.standard_normal((args.batch, cfg.num_dense_features)
                                    ).astype(np.float32)
        cat = np.stack([zipf_ids(rng, t.vocab_size, (args.batch, 1))
                        for t in cfg.tables], axis=1).astype(np.int32)
        reqs.append((dense, cat))
    return reqs


def plain_predict(cfg, pdb, params, dev, dense, cat):
    """The plain path: pooled rows straight from the PDB memmap, the dense
    net with the plain dot interaction, then the sigmoid."""
    import numpy as np
    import torch
    from repro_torch.models.recsys.model import RecsysModel
    emb = np.stack([pdb.fetch(cfg.name, t.name, cat[:, ti, 0])
                    for ti, t in enumerate(cfg.tables)], axis=1)
    model = RecsysModel(cfg, device=dev, use_kernels=False)
    with torch.no_grad():
        logit = model.apply_dense(params, torch.from_numpy(dense).to(dev),
                                  torch.from_numpy(emb).to(dev))
    return torch.sigmoid(logit).cpu().numpy(), emb


def profile_predict(server, dense, cat) -> None:
    """Where one served batch's time goes: the host wall time of a
    ``predict`` call against the device's busy time in it (the sum of
    kernel times from ``torch.profiler``), and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.predict(dense, cat)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile predict: wall {wall:.2f} ms; device time not "
              "measured (the profiler recorded no device events)")
        return
    busy = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile predict: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), {len(kernels)} device events; top: "
          + "; ".join(f"{n[:48]} {t:.3f} ms" for n, t in top))


def serve_phase(args, ps_path, cfg, pdb, params, dev, payload_dtype):
    import numpy as np
    import torch
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.serve import build_server_from_config

    server, _ = build_server_from_config(ps_path, device=dev,
                                         payload_dtype=payload_dtype)
    warm = make_requests(args, cfg, args.warmup, 1)
    reqs = make_requests(args, cfg, args.requests, 2)
    try:
        for dense, cat in warm:                  # fill L1, warm the caches
            server.predict(dense, cat)
        server.reset_latencies()
        before = {k: c.counters() for k, c in server.hps.caches.items()}
        server.start()
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        handles = [server.submit(d, c) for d, c in reqs]
        preds = [h.get(timeout=600) for h in handles]
        probe = server.hps.caches[cfg.tables[0].name].query(
            reqs[0][1][:, 0, 0].astype(np.int64))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = LAUNCHES.snapshot()
        server.stop()
        for p in preds:
            if isinstance(p, Exception):
                raise p
        after = {k: c.counters() for k, c in server.hps.caches.items()}
        hits = sum(after[k]["hits"] - before[k]["hits"] for k in after)
        miss = sum(after[k]["misses"] - before[k]["misses"] for k in after)
        pct = server.latency_percentiles()      # submit burst, queueing in
        server.reset_latencies()
        for dense, cat in reqs[:8]:             # one request at a time
            server.predict(dense, cat)
        seq = server.latency_percentiles()
        profile_predict(server, *reqs[8 % len(reqs)])

        # predictions against the plain path
        err = 0.0
        for (dense, cat), p in zip(reqs, preds):
            check(p.shape == (args.batch,) and np.isfinite(p).all(),
                  f"{payload_dtype}: bad prediction block {p.shape}")
            want, emb = plain_predict(cfg, pdb, params, dev, dense, cat)
            err = max(err, float(np.abs(p - want).max()))
        tol = SERVE_TOL[payload_dtype]
        check(err <= tol, f"{payload_dtype}: served predictions deviate "
              f"{err} from the plain path (bound {tol})")
        # the pooled L1 read itself: bit-exact for f32, within half a
        # quantization step for int8
        dense, cat = reqs[-1]
        got = server.hps.lookup(cat).cpu().numpy()
        _, emb = plain_predict(cfg, pdb, params, dev, dense, cat)
        if payload_dtype == "f32":
            check(np.array_equal(got, emb), "f32 L1 read is not bit-exact")
        else:
            step = np.abs(emb).max(axis=2, keepdims=True) / 127.0
            check(bool((np.abs(got - emb) <= 0.5 * step + 1e-6).all()),
                  "int8 L1 read exceeds half a quantization step")
        first = probe.cpu().numpy()
        want_rows = pdb.fetch(cfg.name, cfg.tables[0].name,
                              reqs[0][1][:, 0, 0])
        check(np.abs(first - want_rows).max() <= (
            0 if payload_dtype == "f32" else
            np.abs(want_rows).max() / 254 + 1e-6),
            "DeviceEmbeddingCache.query rows disagree with the PDB")
    finally:
        server.close()
    # f32 reads go through K1 (pooled) and K5 (the cache query); int8
    # reads through K6 for both
    need = (["lookup_fwd", "gather_rows"] if payload_dtype == "f32"
            else ["dequant_gather_rows"]) + ["interaction_fwd"]
    for k in need:
        check(launches.get(k, 0) > 0,
              f"{payload_dtype}: kernel {k} was not launched on the main "
              f"path (counts {launches})")
    hit = hits / max(1, hits + miss)
    print(f"serve {payload_dtype} on {torch.cuda.get_device_name(0)}: "
          f"{len(reqs)} requests x {args.batch} rows in {wall:.2f} s "
          f"through submit (per-group p50 {pct['p50']:.2f} ms, p99 "
          f"{pct['p99']:.2f} ms, queueing included); one request at a "
          f"time through predict: p50 {seq['p50']:.2f} ms; "
          f"L1 hit rate {hit:.4f}; max |p - plain| {err:.3g} "
          f"(bound {tol}); launches {launches}")
    return launches, err


def main() -> int:
    args = RUN
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing measured", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port is missing ({SRC}/repro_torch); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0])
    dev = torch.device("cuda", 0)

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.build_info['path']})")
    print(_build.build_info["log"].strip())

    # 3. kernels against their plain versions
    from repro_torch.models.recsys.layers import pin_f32_matmul
    pin_f32_matmul()
    kernels = kernel_phase(args, dev)

    # 4-5. bundle and serve
    bundle_dir = os.path.join(ROOT, "_smoke_bundle")
    shutil.rmtree(bundle_dir, ignore_errors=True)
    try:
        cfg, pdb, params = write_full_bundle(args, bundle_dir, dev)
        ps = os.path.join(bundle_dir, "ps.json")
        total = {}
        for pd in ("f32", "int8"):
            launches, _ = serve_phase(args, ps, cfg, pdb, params, dev, pd)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
    finally:
        shutil.rmtree(bundle_dir, ignore_errors=True)

    # 6. kernels line, then the device line last
    for name, rec in kernels.items():
        rec["launches"] = total.get(name, 0)
        check(rec["launches"] > 0, f"{name}: no launches on the main path")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
