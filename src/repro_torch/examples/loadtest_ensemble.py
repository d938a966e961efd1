"""Load-testing an ensemble deployment: open-loop traffic, latency SLOs,
and admission-controlled serving, end to end (the twin of
``examples/loadtest_ensemble.py``).

The walkthrough:

1. Train TWO recipes briefly and write one ensemble bundle
   (``api.deploy_ensemble``: shared PDB/VDB/bus, per-model L1 caches).
2. Stand the bundle back up and arm each member's ADMISSION CONTROLLER:
   a bounded request queue, a declared latency SLO, and deadline-aware
   dynamic batching (grow groups toward ``max_batch`` while the oldest
   queued request's slack allows, cut early, and shed expired requests,
   when it does not).
3. Generate a SEEDED OPEN-LOOP workload: Poisson arrivals at a target
   qps, Zipf-skewed ids whose hot set drifts over time, and a 3:1
   traffic mix across the two models. Record it to a JSONL trace: the
   trace IS the workload, so this exact run is reproducible anywhere.
4. Drive it open-loop (submission happens on schedule whether or not
   the servers keep up: late responses count against latency), then
   push a deliberate OVERLOAD phase and watch graceful shedding: typed
   ``ServerOverloaded`` rejections, never hung callers.
5. Print the per-model picture from both sides: client-observed
   p50/p99/p999 + delivered qps, and the servers' own shed / expiry /
   SLO-violation counters.

Run:  PYTHONPATH=src python -m repro_torch.examples.loadtest_ensemble \
          [--device cpu] [--train-steps 10] [--duration 3]
          [--overload-duration 1.5]
"""
import argparse
import os
import tempfile

from repro_torch.launch.loadtest import main as loadtest_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--overload-duration", type=float, default=1.5)
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    with tempfile.TemporaryDirectory(prefix="loadtest_demo_") as root:
        trace = os.path.join(root, "steady.jsonl")
        artifact = os.path.join(root, "loadtest.json")
        result = loadtest_main([
            # 1) demo deploy: 2-model ensemble bundle
            "--arch", "dlrm-criteo,dcn-criteo",
            "--train-steps", str(args.train_steps),
            "--deploy-dir", os.path.join(root, "bundle"),
            # 2) admission: bounded queue, 150ms SLO, deadline batching
            "--queue-depth", "32",
            "--slo-ms", "150",
            # 3) seeded workload: Poisson, drifting Zipf, 3:1 mix,
            #    recorded to a trace
            "--qps", "25", "--duration", str(args.duration), "--rows", "4",
            "--zipf-a", "1.2", "--drift-per-s", "0.02",
            "--mix", "dlrm-criteo-smoke=3,dcn-criteo-smoke=1",
            "--seed", "7",
            "--trace-out", trace,
            # 4) deliberate overload: watch sheds, not hangs
            "--overload-qps", "400",
            "--overload-duration", str(args.overload_duration),
            "--artifacts", artifact,
            # (no --smoke-assert here: hot-set drift deliberately ages
            # the L1 caches, so an occasional steady-phase expiry is the
            # drift regime working as intended)
            *device,
        ])
        print(f"\ntrace was recorded to {trace}")
    return result


if __name__ == "__main__":
    main()
