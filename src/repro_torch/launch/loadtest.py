"""Load-test launcher: seeded open-loop traffic against a deployment
bundle, with latency SLOs and admission-controlled serving (counterpart of
``repro/launch/loadtest.py``).

Stands a bundle back up exactly like ``launch.serve`` (ps.json is all it
needs) on ``--device`` (``cuda`` unless ``--device cpu``), arms each
member's admission controller (bounded queue + declared SLO +
deadline-aware batching), then drives a seeded open-loop workload
(Poisson or constant-rate arrivals, Zipf popularity with optional hot-set
drift, multi-model mix) through the
:class:`~repro_torch.loadgen.driver.OpenLoopDriver` — submission happens
at the SCHEDULED offsets whether or not the server keeps up, so overload
shows up as tail latency and sheds instead of silently slowing the
benchmark (no coordinated omission).

Two phases run by default: a ``steady`` phase at ``--qps`` and, when
``--overload-qps`` is set, an ``overload`` phase pushing the offered
rate past capacity so the admission controller's shedding is visible.
The per-phase, per-model picture — client-observed p50/p99/p999,
delivered-qps series, shed / SLO-violation / expiry counts from BOTH
sides (driver-observed and server counters) — persists to
``--artifacts`` (default ``artifacts/loadtest_torch.json``, beside the
reference's ``artifacts/loadtest.json``, in the same key tree).

  # demo on the CPU: train 2 smoke recipes briefly, deploy an ensemble
  # bundle, load-test it
  PYTHONPATH=src python -m repro_torch.launch.loadtest --device cpu \
      --arch dlrm-criteo,dcn-criteo --qps 30 --duration 3 \
      --slo-ms 100 --queue-depth 64 --overload-qps 400

  # load-test an existing bundle on the card; record the workload for
  # exact replay
  PYTHONPATH=src python -m repro_torch.launch.loadtest \
      --config /path/ps.json --qps 50 --duration 5 \
      --trace-out /tmp/steady.jsonl

  # replay a recorded trace (the trace IS the workload; a trace of either
  # package replays in the other)
  PYTHONPATH=src python -m repro_torch.launch.loadtest \
      --config /path/ps.json --trace-in /tmp/steady.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.registry import RECSYS_RECIPES
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.device import DeviceLike
from repro_torch.launch.serve import (_members, _train_and_deploy,
                                      build_server_from_config)
from repro_torch.loadgen.driver import OpenLoopDriver
from repro_torch.loadgen.workload import (ModelShape, Workload,
                                          WorkloadConfig, record_trace,
                                          replay_trace)
from repro_torch.serve.server import MultiModelServer

LOADTEST_ARTIFACT = "artifacts/loadtest_torch.json"


def _parse_mix(spec: Optional[str]) -> Optional[Dict[str, float]]:
    """``"dlrm=3,dcn=1"`` -> ``{"dlrm": 3.0, "dcn": 1.0}``."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        name, _, w = part.partition("=")
        out[name.strip()] = float(w) if w else 1.0
    return out


def _stand_up(ps_path: str, *, cache_capacity, device: DeviceLike = None):
    """Bundle -> servers on ``device`` (admission NOT yet armed) + model
    shapes."""
    built, loaded = build_server_from_config(
        ps_path, device=device, cache_capacity=cache_capacity)
    servers, models = _members(built, loaded)
    if isinstance(built, MultiModelServer):
        submit = built.submit
    else:
        submit = lambda _model, dense, cat: built.submit(dense, cat)
    shapes = {n: ModelShape.from_config(s.model.cfg)
              for n, s in servers.items()}
    return built, servers, models, shapes, submit


def _warmup(servers, rows: int, max_coalesce: int) -> None:
    """Run every path the measured phases will hit, off the clock —
    BEFORE admission is armed, so a first-use cost can never expire a
    warmup request. On the card these are the kernel library's first
    load, cuBLAS's heuristics for each group shape and the caching
    allocator's growth (where the reference warms its jit compiles).

    Two rounds: the sync ``predict`` path runs every group shape the
    batcher can form (the coalescer concatenates whole requests, so
    group row counts are ``rows * k`` for ``k`` in 1..max_coalesce),
    then bursts through ``submit`` warm the serve loop's OWN path (the
    stream pipeline's stages and threads). Servers come back STOPPED so
    the caller can arm admission and restart."""
    data = {n: SyntheticCTR(s.model.cfg, rows) for n, s in servers.items()}
    for n, s in servers.items():
        base = data[n].batch(10_000)
        for k in range(1, max_coalesce + 1):
            dense = np.concatenate([base["dense"]] * k)
            cat = np.concatenate([base["cat"]] * k)
            s.predict(dense, cat)
    for s in servers.values():
        s.start()
    for r in range(3):
        handles = []
        for n, s in servers.items():
            for k in range(max_coalesce):
                req = data[n].batch(30_000 + 10 * r + k)
                handles.append(s.submit(req["dense"], req["cat"]))
        for h in handles:
            out = h.get(timeout=300)
            if isinstance(out, BaseException):
                raise out
    for s in servers.values():
        s.stop()
        s.reset_serving_stats()


def _run_phase(name: str, driver: OpenLoopDriver, requests, servers,
               trace_out: Optional[str] = None) -> Dict:
    """One driver run + both-sides stats; resets server counters so the
    next phase starts clean."""
    if trace_out:
        n = record_trace(trace_out, requests)
        print(f"[{name}] recorded {n} requests -> {trace_out}")
        requests = replay_trace(trace_out)
    t0 = time.time()
    client = driver.run(requests)
    dt = time.time() - t0
    server_side = {}
    for n, s in servers.items():
        c = s.counters()
        server_side[n] = {
            "requests_delivered": c["requests_delivered"],
            "requests_shed": c["requests_shed"],
            "requests_expired": c["requests_expired"],
            "slo_violations": c["slo_violations"],
            "groups_served": c["groups_served"],
            "latency_ms": s.latency_percentiles(),
        }
        s.reset_serving_stats()
    print(f"[{name}] {client['scheduled']} scheduled in {dt:.1f}s "
          f"(max submit lag {client['max_submit_lag_ms']:.1f}ms)")
    for n, m in client["models"].items():
        lat = m["latency_ms"]
        sheds = server_side[n]["requests_shed"] \
            + server_side[n]["requests_expired"]
        print(f"[{name}][{n}] delivered={m['delivered']} "
              f"shed={m['shed_observed']} (server-side {sheds}) "
              f"lost={m['lost']} "
              f"p50={lat['p50']:.1f} p99={lat['p99']:.1f} "
              f"p999={lat['p999']:.1f}ms "
              f"slo_violations={m['slo_violations_observed']}")
    return {"client": client, "server": server_side}


def _smoke_assert(result: Dict, artifact: str) -> None:
    """The CI loadtest-smoke contract, as explicit raises (asserts
    vanish under ``python -O``): p99 measured, no sheds at low load,
    sheds observed in the deliberate overload phase, artifact written."""
    steady = result["phases"].get("steady")
    if not steady:
        raise SystemExit("smoke: no steady phase in result")
    for n, m in steady["client"]["models"].items():
        if m["delivered"] <= 0:
            raise SystemExit(f"smoke: model {n!r} delivered nothing")
        if m["latency_ms"]["p99"] <= 0:
            raise SystemExit(f"smoke: model {n!r} reports no p99")
        if m["lost"] > 0:
            raise SystemExit(f"smoke: model {n!r} lost {m['lost']} "
                             "responses to the drain timeout")
        sheds = steady["server"][n]["requests_shed"] \
            + steady["server"][n]["requests_expired"]
        if sheds > 0:
            raise SystemExit(f"smoke: model {n!r} shed {sheds} at "
                             "steady (under-capacity) load")
    over = result["phases"].get("overload")
    if over is not None:
        total_shed = sum(
            s["requests_shed"] + s["requests_expired"]
            for s in over["server"].values())
        if total_shed <= 0:
            raise SystemExit("smoke: deliberate overload phase shed "
                             "nothing — admission control inert?")
    if not os.path.exists(artifact):
        raise SystemExit(f"smoke: artifact {artifact} not written")
    print("smoke assertions passed: p99 reported, zero sheds at low "
          "load" + ("" if over is None
                    else f", {total_shed} sheds under overload"))


def main(argv=None) -> Dict:
    """Run the load test; returns the result written to ``--artifacts``."""
    ap = argparse.ArgumentParser(
        description="Open-loop load test against a deployment bundle "
                    "with latency SLOs and admission-controlled serving")
    ap.add_argument("--config", default=None,
                    help="ps.json of an existing deployment bundle")
    ap.add_argument("--arch", default="dlrm-criteo",
                    help="demo mode (no --config): train+deploy these "
                         "recipes first (comma-separated; 2+ archs "
                         "deploy an ensemble bundle)")
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--deploy-dir", default=None)
    ap.add_argument("--cache-capacity", type=int, default=None)
    # workload
    ap.add_argument("--qps", type=float, default=30.0,
                    help="offered request rate of the steady phase")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="steady-phase length in seconds")
    ap.add_argument("--rows", type=int, default=4,
                    help="rows per request")
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "constant"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--zipf-a", type=float, default=1.2)
    ap.add_argument("--drift-per-s", type=float, default=0.0,
                    help="fraction of the vocab the hot set shifts per "
                         "second (0 = stationary popularity)")
    ap.add_argument("--mix", default=None,
                    help="model traffic weights, e.g. 'dlrm=3,dcn=1' "
                         "(default: uniform over deployed models)")
    ap.add_argument("--trace-out", default=None,
                    help="record the steady workload to this JSONL "
                         "trace, then drive the run from the replay")
    ap.add_argument("--trace-in", default=None,
                    help="drive the steady phase from a recorded trace "
                         "instead of generating a workload")
    # admission / SLO
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="declared per-request latency SLO")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="admission queue bound per model (0 = "
                         "unbounded)")
    ap.add_argument("--no-deadline-batching", action="store_true",
                    help="fixed max_batch coalescing instead of "
                         "deadline-aware batch sizing + expiry drops")
    ap.add_argument("--max-coalesce", type=int, default=4,
                    help="max requests per coalesced group (sets "
                         "max_batch = rows * this; every resulting "
                         "group shape runs during warmup)")
    # overload phase
    ap.add_argument("--overload-qps", type=float, default=None,
                    help="offered rate of a second, deliberately "
                         "overloaded phase (default: skip the phase)")
    ap.add_argument("--overload-duration", type=float, default=2.0)
    ap.add_argument("--drain-timeout", type=float, default=60.0)
    ap.add_argument("--artifacts", default=LOADTEST_ARTIFACT)
    ap.add_argument("--smoke-assert", action="store_true",
                    help="CI gate: fail unless p99 is reported, the "
                         "steady phase shed nothing and the overload "
                         "phase (if run) shed something")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ps_path = args.config
    if ps_path is None:
        archs = [a.strip() for a in args.arch.split(",") if a.strip()]
        known = tuple(sorted(RECSYS_RECIPES))
        bad = [a for a in archs if a not in known]
        if bad:
            ap.error(f"unknown arch(es) {bad}; choose from {known}")
        deploy_dir = args.deploy_dir or tempfile.mkdtemp(prefix="hps_")
        ps_path = _train_and_deploy(archs, args.train_steps,
                                    max(args.rows, 16), deploy_dir,
                                    args.cache_capacity,
                                    device=args.device)
        print(f"deployment bundle: {deploy_dir}")

    built, servers, models, shapes, submit = _stand_up(
        ps_path, cache_capacity=args.cache_capacity, device=args.device)
    for s in servers.values():
        s.max_batch = args.rows * args.max_coalesce

    driver = OpenLoopDriver(submit, slo_ms=args.slo_ms,
                            drain_timeout_s=args.drain_timeout)
    phases = {}
    _warmup(servers, args.rows, args.max_coalesce)
    for s in servers.values():    # arm admission on the warm,
        s.set_admission(          # stopped servers, then restart
            queue_depth=args.queue_depth or None,
            slo_ms=args.slo_ms,
            deadline_batching=not args.no_deadline_batching)
        s.start()
    try:
        if args.trace_in:
            steady_reqs = replay_trace(args.trace_in)
        else:
            steady_cfg = WorkloadConfig(
                qps=args.qps, duration_s=args.duration,
                rows=args.rows, arrival=args.arrival,
                seed=args.seed, zipf_a=args.zipf_a,
                drift_per_s=args.drift_per_s,
                mix=_parse_mix(args.mix))
            steady_reqs = Workload(steady_cfg, shapes)
        phases["steady"] = _run_phase("steady", driver, steady_reqs,
                                      servers,
                                      trace_out=args.trace_out)
        if args.overload_qps is not None:
            over_cfg = WorkloadConfig(
                qps=args.overload_qps,
                duration_s=args.overload_duration, rows=args.rows,
                arrival=args.arrival, seed=args.seed + 1,
                zipf_a=args.zipf_a, drift_per_s=args.drift_per_s,
                mix=_parse_mix(args.mix))
            phases["overload"] = _run_phase(
                "overload", driver, Workload(over_cfg, shapes),
                servers)
    finally:
        # close, not stop: every still-queued handle gets the typed
        # rejection — the driver's drain already collected the rest
        built.close()

    result = {
        "ps_config": os.path.abspath(ps_path),
        "workload": {
            "qps": args.qps, "duration_s": args.duration,
            "rows": args.rows, "arrival": args.arrival,
            "seed": args.seed, "zipf_a": args.zipf_a,
            "drift_per_s": args.drift_per_s, "mix": _parse_mix(args.mix),
            "overload_qps": args.overload_qps,
        },
        "admission": {
            "slo_ms": args.slo_ms, "queue_depth": args.queue_depth,
            "deadline_batching": not args.no_deadline_batching,
        },
        "phases": phases,
    }
    os.makedirs(os.path.dirname(args.artifacts) or ".", exist_ok=True)
    with open(args.artifacts, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.artifacts}")

    if args.smoke_assert:
        _smoke_assert(result, args.artifacts)
    return result


if __name__ == "__main__":
    main()
