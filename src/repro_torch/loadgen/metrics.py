"""Bounded-memory serving metrics, copied from
``repro/loadgen/metrics.py``: the log-bucketed latency histogram and the
windowed delivered-rate counter.

``LatencyHistogram`` is the latency store of ``InferenceServer``'s
per-group samples, as in the reference:

- **Bounded memory.** A fixed array of geometrically-spaced buckets
  (default ~2% relative width over 1us..10min): a long soak costs the
  same few KiB as a smoke run.
- **Mergeable.** Bucket counts add elementwise (``merge``), and a JSON
  round-trip (``to_dict`` / ``from_dict``) is exact; a histogram of
  either package reads back in the other.
- **Quantile error is bounded by the bucket width** (~2% relative); the
  mean is exact (the sum is kept apart).

Neither class locks internally: callers own the synchronization
(``InferenceServer`` keeps its histogram behind ``_stats_lock``).
The rest of the reference's ``loadgen`` is ported beside it: the
workload generators (``loadgen/workload.py``) and the open-loop runner
(``loadgen/driver.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


class LatencyHistogram:
    """Log-bucketed latency histogram in milliseconds.

    Bucket 0 holds everything at or below ``lo_ms``; the last bucket is
    the overflow above ``hi_ms``; in between, bucket edges grow by
    ``growth`` per bucket, so a recorded value's bucket midpoint is
    within ~``growth - 1`` relative error of the true value.
    """

    def __init__(self, lo_ms: float = 1e-3, hi_ms: float = 6e5,
                 growth: float = 1.02):
        if not (lo_ms > 0 and hi_ms > lo_ms and growth > 1):
            raise ValueError("need lo_ms > 0, hi_ms > lo_ms, growth > 1")
        self.lo_ms = lo_ms
        self.hi_ms = hi_ms
        self.growth = growth
        self._log_g = math.log(growth)
        # bucket 0: (-inf, lo]; 1..n: log-spaced; n+1: overflow
        self._n = int(math.ceil(math.log(hi_ms / lo_ms) / self._log_g))
        self.counts = np.zeros(self._n + 2, np.int64)
        self.sum_ms = 0.0

    # -- recording ----------------------------------------------------------

    def _bucket(self, ms: float) -> int:
        if ms <= self.lo_ms:
            return 0
        idx = 1 + int(math.log(ms / self.lo_ms) / self._log_g)
        return min(idx, self._n + 1)

    def record(self, ms: float) -> None:
        self.counts[self._bucket(ms)] += 1
        self.sum_ms += ms

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum_ms / n if n else 0.0

    def reset(self) -> None:
        self.counts[:] = 0
        self.sum_ms = 0.0

    # -- quantiles ----------------------------------------------------------

    def _edge(self, idx: int) -> float:
        """Representative latency for bucket ``idx`` (geometric mid)."""
        if idx <= 0:
            return self.lo_ms
        if idx > self._n:
            return self.hi_ms
        return self.lo_ms * self.growth ** (idx - 0.5)

    def percentile(self, q: float) -> float:
        """Latency (ms) at percentile ``q`` in [0, 100]; 0.0 if empty."""
        n = self.count
        if n == 0:
            return 0.0
        rank = max(1, int(math.ceil(q / 100.0 * n)))
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, rank))
        return float(self._edge(idx))

    def summary(self) -> Dict[str, float]:
        """The standard serving picture: p50/p95/p99/p999 + exact mean."""
        return {"p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "p999": self.percentile(99.9),
                "mean": self.mean, "count": float(self.count)}

    # -- merge / persistence ------------------------------------------------

    def _compatible(self, other: "LatencyHistogram") -> bool:
        return (self.lo_ms == other.lo_ms and self.hi_ms == other.hi_ms
                and self.growth == other.growth)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add ``other``'s counts into this histogram (same bucketing)."""
        if not self._compatible(other):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        self.counts += other.counts
        self.sum_ms += other.sum_ms
        return self

    def snapshot(self) -> "LatencyHistogram":
        """Independent copy (take under the owner's lock, read outside)."""
        h = LatencyHistogram(self.lo_ms, self.hi_ms, self.growth)
        h.counts = self.counts.copy()
        h.sum_ms = self.sum_ms
        return h

    def to_dict(self) -> Dict:
        nz = np.nonzero(self.counts)[0]
        return {"lo_ms": self.lo_ms, "hi_ms": self.hi_ms,
                "growth": self.growth, "sum_ms": self.sum_ms,
                "buckets": {int(i): int(self.counts[i]) for i in nz}}

    @classmethod
    def from_dict(cls, d: Dict) -> "LatencyHistogram":
        h = cls(d["lo_ms"], d["hi_ms"], d["growth"])
        for i, c in d["buckets"].items():
            h.counts[int(i)] = c
        h.sum_ms = d["sum_ms"]
        return h


class WindowedRate:
    """Delivered-throughput series over fixed time windows.

    ``record(t)`` takes seconds relative to the run start; the series
    reports one ``(window_start_s, per_second_rate)`` pair per non-empty
    window — memory is bounded by the run duration / window size, never
    by the request count.
    """

    def __init__(self, window_s: float = 1.0):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = window_s
        self._counts: Dict[int, int] = {}

    def record(self, t_s: float, n: int = 1) -> None:
        self._counts[int(t_s // self.window_s)] = \
            self._counts.get(int(t_s // self.window_s), 0) + n

    def merge(self, other: "WindowedRate") -> "WindowedRate":
        if self.window_s != other.window_s:
            raise ValueError("window size mismatch")
        for w, n in other._counts.items():
            self._counts[w] = self._counts.get(w, 0) + n
        return self

    @property
    def total(self) -> int:
        return sum(self._counts.values())

    def series(self) -> List[Tuple[float, float]]:
        return [(w * self.window_s, n / self.window_s)
                for w, n in sorted(self._counts.items())]

    def peak(self) -> float:
        return max((n / self.window_s for n in self._counts.values()),
                   default=0.0)
