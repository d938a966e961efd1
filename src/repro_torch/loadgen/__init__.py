"""Serving metrics (counterpart of ``repro/loadgen``): the latency
histogram and the windowed rate. The workload generators and the
open-loop runner are ROADMAP queue 1 item 6."""
from repro_torch.loadgen.metrics import LatencyHistogram, WindowedRate

__all__ = ["LatencyHistogram", "WindowedRate"]
