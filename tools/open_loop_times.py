#!/usr/bin/env python3
"""Where a load-test request's time goes, on the port found under
``--src``, at ``chip_smoke.py``'s full-width DLRM serving shapes:

  python3 tools/open_loop_times.py [--src PATH] [--bundle DIR] [--qps Q ...]
                                   [--switch-interval S]

Uses ``tools/serve_times.py``'s random-table DLRM bundle (26 tables at D
128, each vocabulary capped at ``--vocab`` rows, ``RUN.cache_capacity`` L1
rows a table; written once into ``--bundle``). Then, on one fresh server:

1. ``predict`` one at a time (closed loop) on requests of ``--rows`` rows:
   first ``chip_smoke.make_requests``'s Zipf(1.1) rows (the ids the
   bundle's warm-up serves), then ``loadgen.Workload``'s (Zipf 1.2 over a
   seeded permutation of each vocabulary, as ``launch.loadtest`` sends):
   p50 / p99 ms and the L1 hit rate of each;
2. the host profile (``cProfile``) of 32 more ``Workload`` requests
   through ``predict``: the functions with the most cumulative time, then
   those with the most time of their own (numpy's C calls among them);
3. 32 more fresh ``Workload`` requests through ``submit`` one at a time
   (closed loop) for each engine, ``stream``, ``sync``, ``stage_sync``:
   p50 / p99 ms and the L1 hit rate of each;
4. ``launch.loadtest.main`` on the bundle for each ``--qps`` (``--rows``
   rows a request, ``--max-coalesce 4``, SLO 100 ms, ``queue_depth`` 64,
   a 3 s steady phase): delivered, shed + expired, p50 / p99 ms and the
   largest submit lag.

``--switch-interval`` sets the interpreter's thread switch interval
(``sys.setswitchinterval``, 0.005 s by default) for the whole run: the
longest a thread that gave up the interpreter lock for a device call or a
wait can be kept from it by a thread running Python.

Prints the card's name and power limit, the profile, then one JSON line.
Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hit_rate(server) -> float:
    c = [x.counters() for x in server.hps.caches.values()]
    hits, miss = sum(x["hits"] for x in c), sum(x["misses"] for x in c)
    return hits / max(1, hits + miss)


def _closed_loop(server, reqs, engine=None) -> dict:
    """``reqs`` one at a time through ``predict``, or through ``submit``
    on ``engine``'s serve loop."""
    import numpy as np
    h0 = [x.counters() for x in server.hps.caches.values()]
    ms = []
    if engine is not None:
        server.engine = engine
        server.start()
    for dense, cat in reqs:
        t0 = time.perf_counter()
        if engine is None:
            server.predict(dense, cat)
        else:
            out = server.submit(dense, cat).get(timeout=300)
            if isinstance(out, BaseException):
                raise out
        ms.append(1e3 * (time.perf_counter() - t0))
    if engine is not None:
        server.stop()
    h1 = [x.counters() for x in server.hps.caches.values()]
    hits = sum(b["hits"] - a["hits"] for a, b in zip(h0, h1))
    miss = sum(b["misses"] - a["misses"] for a, b in zip(h0, h1))
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "l1_hit_rate": hits / max(1, hits + miss)}


def measure(cs, ps: str, dev, rows: int, qps_list) -> dict:
    import types
    from repro_torch.launch import loadtest
    from repro_torch.launch.serve import build_server_from_config
    from repro_torch.loadgen import ModelShape, Workload, WorkloadConfig
    out = {}
    server, _ = build_server_from_config(ps, device=dev)
    try:
        cfg = server.model.cfg
        run = types.SimpleNamespace(**{**vars(cs.RUN), "batch": rows})
        warm = cs.make_requests(run, cfg, cs.RUN.warmup, 1)
        syn = cs.make_requests(run, cfg, 64, 2)
        wl = [(r.dense, r.cat) for r in Workload(
            WorkloadConfig(qps=1000.0, duration_s=0.3, rows=rows, seed=7,
                           zipf_a=1.2), {"m": ModelShape.from_config(cfg)})]
        for d, c in warm:
            server.predict(d, c)
        out["predict zipf 1.1 (warm ids)"] = _closed_loop(server, syn)
        out["predict workload, first 64"] = _closed_loop(server, wl[:64])
        out["predict workload, next 64"] = _closed_loop(server, wl[64:128])
        prof = cProfile.Profile()
        prof.enable()
        _closed_loop(server, wl[128:160])
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative") \
            .print_stats(25)
        pstats.Stats(prof, stream=buf).sort_stats("tottime") \
            .print_stats(25)
        print(buf.getvalue())
        for i, engine in enumerate(("stream", "sync", "stage_sync")):
            out[f"submit {engine}, fresh 32"] = _closed_loop(
                server, wl[160 + 32 * i:192 + 32 * i], engine)
    finally:
        server.close()
    for qps in qps_list:
        with tempfile.TemporaryDirectory() as d:
            res = loadtest.main([
                "--config", ps, "--device", dev.type, "--rows", str(rows),
                "--max-coalesce", "4", "--qps", repr(qps), "--duration",
                "3", "--seed", "7", "--zipf-a", "1.2", "--slo-ms", "100",
                "--queue-depth", "64",
                "--artifacts", os.path.join(d, "a.json")])
        st = res["phases"]["steady"]
        (m,) = st["client"]["models"].values()
        (s,) = st["server"].values()
        out[f"open loop {qps} qps"] = {
            "scheduled": m["scheduled"], "delivered": m["delivered"],
            "shed_or_expired": s["requests_shed"] + s["requests_expired"],
            "p50_ms": m["latency_ms"]["p50"],
            "p99_ms": m["latency_ms"]["p99"],
            "max_submit_lag_ms": st["client"]["max_submit_lag_ms"],
            "groups": s["groups_served"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--bundle",
                    default=os.path.join(ROOT, ".archive",
                                         "serve_times_bundle"))
    ap.add_argument("--vocab", type=int, default=1 << 20)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--switch-interval", type=float, default=None,
                    help="sys.setswitchinterval for the run (seconds)")
    ap.add_argument("--qps", type=float, nargs="*",
                    default=[5.0, 10.0, 20.0, 40.0])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("open_loop_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    sys.path.insert(2, os.path.join(ROOT, "tools"))
    import chip_smoke as cs
    import serve_times
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ps = serve_times._bundle(cs, args.bundle, args.vocab)
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    out = measure(cs, ps, torch.device("cuda", 0), args.rows, args.qps)
    print(json.dumps({"src": args.src, "rows": args.rows,
                      "switch_interval_s": sys.getswitchinterval(),
                      "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
