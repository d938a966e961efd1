"""Production traffic harness: open-loop load generation against the
serving stack (counterpart of ``repro/loadgen``).

Three layers (see the module docstrings for the contracts):

- :mod:`repro_torch.loadgen.workload` — seeded open-loop request
  generators (Poisson / constant-rate arrivals, Zipf-skewed id popularity
  with hot-set drift, multi-model traffic mixes) and a JSONL trace
  record/replay format so any run is exactly reproducible; the
  reference's streams and traces bit for bit.
- :mod:`repro_torch.loadgen.metrics` — bounded-memory mergeable latency
  histogram (log-bucketed p50/p99/p999) and windowed delivered-qps
  counters.
- :mod:`repro_torch.loadgen.driver` — the open-loop driver: submits on
  schedule WITHOUT waiting for completions, so late responses count
  against latency (coordinated-omission-free), and collects per-model
  delivered/shed/violation statistics.

The CLI front door is ``python -m repro_torch.launch.loadtest``.
"""
from repro_torch.loadgen.metrics import LatencyHistogram, WindowedRate
from repro_torch.loadgen.workload import (ModelShape, Request,
                                          WorkloadConfig, Workload,
                                          record_trace, replay_trace)
from repro_torch.loadgen.driver import OpenLoopDriver

__all__ = [
    "LatencyHistogram", "WindowedRate", "ModelShape", "Request",
    "WorkloadConfig", "Workload", "record_trace", "replay_trace",
    "OpenLoopDriver",
]
