#!/usr/bin/env python3
"""Serving latency of the port found under ``--src``, at ``chip_smoke.py``'s
full-width DLRM serving shapes, so that two checkouts can be timed in turns
on one card:

  python3 tools/serve_times.py [--src PATH] [--label NAME] [--bundle DIR]

Writes (once, into ``--bundle``, default ``.archive/serve_times_bundle``) a
DLRM bundle with ``chip_smoke.py``'s served widths: 26 tables at D 128, each
vocabulary capped at ``--vocab`` rows (random f32 rows from a seed),
``chip_smoke.RUN.cache_capacity`` L1 rows a table and the recipe's dense
net with seed-0 weights; the bundle format is shared by every checkout.
Then, for each engine the checkout's server has, a fresh server from the
bundle serves ``RUN.warmup`` warm-up and ``RUN.requests`` measured
batch-``RUN.batch`` Zipf(1.1) requests (``chip_smoke.make_requests``): all
at once through ``submit`` (a burst, as ``chip_smoke.py``'s engine phase
sends it: delivered rows/s), then one at a time through ``submit``, then
through ``predict``. ``--cache-mesh N`` serves the L1 striped N ways over
a cache mesh that names the card N times (``chip_smoke.striped_ps``'s
ps.json), ``--engines`` picks the engines. Prints the card's name and
power limit, then one JSON line of p50 / p99 ms and the bursts' rows/s. ``--profile ENGINE`` also
prints the host profile (``cProfile``, every thread) of that engine's
burst: the functions with the most time of their own, then the most
cumulative time. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import json
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bundle(cs, directory: str, vocab: int) -> str:
    """The shared bundle's ps.json, written if it is not there yet."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.models.recsys.model import RecsysModel
    from repro_torch.serve.server import write_bundle
    ps = os.path.join(directory, "ps.json")
    if os.path.exists(ps):
        return ps
    cfg = registry.dlrm_criteo
    cfg = dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, vocab_size=min(t.vocab_size, vocab))
        for t in cfg.tables))
    params = RecsysModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(cs.RUN.seed)
    tables = {t.name: rng.standard_normal((t.vocab_size, t.dim),
                                          dtype=np.float32) * 0.1
              for t in cfg.tables}
    write_bundle(directory, api.dlrm_graph(cfg), params, tables,
                 cache_capacity=cs.RUN.cache_capacity,
                 max_batch=cs.RUN.batch)
    return ps


def measure(cs, ps: str, dev, profile: str = "", cache_mesh=None,
            engines=None) -> dict:
    """``{"submit <engine>" / "predict after <engine>": [p50, p99],
    "burst <engine> rows/s": r}`` over the measured requests, a fresh
    server from ``ps`` (its L1 over ``cache_mesh`` where given) for each of
    ``engines`` (default: every engine the server has)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import build_server_from_config
    from repro_torch.serve import server as srv
    base, _ = build_server_from_config(ps, device=dev,
                                       cache_mesh=cache_mesh)
    cfg = base.model.cfg
    warm = cs.make_requests(cs.RUN, cfg, cs.RUN.warmup, 1)
    reqs = cs.make_requests(cs.RUN, cfg, cs.RUN.requests, 2)
    base.close()
    out = {}
    for engine in engines or srv.ENGINES:
        built, _ = build_server_from_config(ps, device=dev,
                                            cache_mesh=cache_mesh)
        server = srv.InferenceServer(built.model, built.dense_params,
                                     built.hps, max_batch=cs.RUN.batch,
                                     engine=engine)
        try:
            server.start()
            cs.closed_loop(server.submit, warm)
            prof = cProfile.Profile() if engine == profile else None
            if prof is not None:
                prof.enable()
            t0 = time.perf_counter()
            cs.burst(server.submit, reqs)
            rate = len(reqs) * cs.RUN.batch / (time.perf_counter() - t0)
            if prof is not None:
                prof.disable()
                for key in ("tottime", "cumulative"):
                    buf = io.StringIO()
                    pstats.Stats(prof, stream=buf).sort_stats(key) \
                        .print_stats(25)
                    print(f"burst {engine}, by {key}:\n{buf.getvalue()}")
            _, ms = cs.closed_loop(server.submit, reqs)
            server.stop()
            pred = []
            for d, c in reqs:
                t0 = time.perf_counter()
                server.predict(d, c)
                pred.append(1e3 * (time.perf_counter() - t0))
        finally:
            server.close()
        out[f"submit {engine}"] = [float(np.percentile(ms, 50)),
                                   float(np.percentile(ms, 99))]
        out[f"predict after {engine}"] = [float(np.percentile(pred, 50)),
                                          float(np.percentile(pred, 99))]
        out[f"burst {engine} rows/s"] = rate
        del server, built
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--bundle",
                    default=os.path.join(ROOT, ".archive",
                                         "serve_times_bundle"))
    ap.add_argument("--vocab", type=int, default=1 << 20)
    ap.add_argument("--profile", default="",
                    help="an engine whose burst is profiled")
    ap.add_argument("--cache-mesh", type=int, default=0, metavar="N",
                    help="serve the L1 striped N ways over a cache mesh "
                    "naming the card N times")
    ap.add_argument("--engines", nargs="*", default=None,
                    help="the engines to time (default: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    ps = _bundle(cs, args.bundle, args.vocab)
    mesh = None
    if args.cache_mesh > 1:
        ps, mesh = cs.striped_ps(ps, args.cache_mesh), [dev] * args.cache_mesh
    out = measure(cs, ps, dev, args.profile, mesh, args.engines)
    print(json.dumps({"label": args.label, "src": args.src,
                      "cache_mesh": args.cache_mesh, "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
