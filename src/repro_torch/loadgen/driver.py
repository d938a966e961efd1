"""The open-loop load driver: submit on schedule, never wait.

A closed-loop benchmark (submit, block, repeat) can only ever measure a
server that is keeping up — when the server slows down, the benchmark
slows its own offered load and the tail disappears (coordinated
omission). This driver is OPEN-LOOP:

- Requests are submitted at their *scheduled* offsets regardless of
  completions; the schedule never waits for the server.
- Latency is measured from the SCHEDULED arrival time to response
  pickup, so a late submit (driver fell behind) and a late response
  both count against latency.
- Completions are collected by a single poller thread that sweeps all
  outstanding handles with non-blocking reads — no per-handle blocking
  ``get``, so one slow response never delays the measurement of the
  responses behind it (head-of-line-free collection, accurate to the
  poll period).

Per model it records delivered latency (mergeable log-bucketed
histogram: p50/p99/p999), a windowed delivered-qps series, observed
shed/rejection counts (typed :class:`~repro_torch.serve.server.
ServerOverloaded` responses), errors, and requests lost to the drain
timeout. ``run`` returns a JSON-ready report; combine it with the
server-side counters (sheds, SLO violations, expiry drops) for the full
picture — ``launch/loadtest.py`` does exactly that and persists
``artifacts/loadtest_torch.json``.

A copy of ``repro/loadgen/driver.py``; the handles are the port's
servers' (``InferenceServer.submit``, ``MultiModelServer.submit``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.loadgen.metrics import LatencyHistogram, WindowedRate
from repro_torch.loadgen.workload import Request

# NOTE: repro_torch.serve.server imports this package's metrics module,
# so the ServerOverloaded import lives inside _sweep (lazy) to break the
# cycle.

#: submit_fn(model, dense, cat) -> handle with queue.Queue semantics
SubmitFn = Callable[[str, np.ndarray, np.ndarray], "object"]


class _ModelStats:
    """Per-model accumulation, owned by the poller thread during a run."""

    def __init__(self):
        self.hist = LatencyHistogram()
        self.rate = WindowedRate()
        self.delivered = 0
        self.shed = 0
        self.errors = 0
        self.slo_violations = 0


class OpenLoopDriver:

    # Checked by `python -m repro_torch.analysis`: the submit thread
    # appends outstanding handles while the poller sweeps and removes them.
    _GUARDED_BY = {
        "_pending": "_pend_lock",
        "_seq": "_pend_lock",
    }

    def __init__(self, submit: SubmitFn, *,
                 slo_ms: Optional[float] = None,
                 poll_s: float = 1e-3,
                 drain_timeout_s: float = 120.0):
        self.submit = submit
        #: client-side SLO: delivered responses slower than this count
        #: as violations in the report (server-side counters are kept
        #: separately by the admission controller)
        self.slo_ms = slo_ms
        self.poll_s = poll_s
        self.drain_timeout_s = drain_timeout_s
        self._pend_lock = threading.Lock()
        # keyed by submission sequence so a sweep removes completions in
        # O(done), not O(pending * done) — at overload tens of thousands
        # of handles can be outstanding, and collection delay would
        # otherwise pollute every measured latency
        self._pending: Dict[int, Tuple[str, float, object]] = {}
        self._seq = 0

    # -- collection ---------------------------------------------------------

    def _sweep(self, t0: float, stats: Dict[str, _ModelStats]) -> int:
        """One non-blocking pass over the outstanding handles; returns
        how many are still pending."""
        from repro_torch.serve.server import ServerOverloaded
        with self._pend_lock:
            snapshot = list(self._pending.items())
        done: List[int] = []
        for key, (model, t_sched, handle) in snapshot:
            try:
                out = handle.get_nowait()
            except queue.Empty:          # still in flight
                continue
            done.append(key)
            st = stats.setdefault(model, _ModelStats())
            if isinstance(out, ServerOverloaded):
                st.shed += 1
            elif isinstance(out, BaseException):
                st.errors += 1
            else:
                now = time.perf_counter() - t0
                ms = (now - t_sched) * 1e3
                st.hist.record(ms)
                st.rate.record(now)
                st.delivered += 1
                if self.slo_ms is not None and ms > self.slo_ms:
                    st.slo_violations += 1
        with self._pend_lock:
            for key in done:
                self._pending.pop(key, None)
            return len(self._pending)

    # -- the run ------------------------------------------------------------

    def run(self, requests: Iterable[Request]) -> Dict:
        """Drive the scheduled stream open-loop; returns the report."""
        stats: Dict[str, _ModelStats] = {}
        scheduled: Dict[str, int] = {}
        stop = threading.Event()
        t0 = time.perf_counter()

        def poll_loop():
            while not stop.is_set():
                self._sweep(t0, stats)
                time.sleep(self.poll_s)
            self._sweep(t0, stats)       # final pass after stop

        poller = threading.Thread(target=poll_loop, daemon=True)
        poller.start()
        late_submit_ms = 0.0
        n_sched = 0
        try:
            for r in requests:
                now = time.perf_counter() - t0
                if r.t > now:
                    time.sleep(r.t - now)
                else:
                    late_submit_ms = max(late_submit_ms,
                                         (now - r.t) * 1e3)
                handle = self.submit(r.model, r.dense, r.cat)
                scheduled[r.model] = scheduled.get(r.model, 0) + 1
                n_sched += 1
                with self._pend_lock:
                    self._pending[self._seq] = (r.model, r.t, handle)
                    self._seq += 1
            # drain: late responses still count against latency
            deadline = time.perf_counter() + self.drain_timeout_s
            while time.perf_counter() < deadline:
                with self._pend_lock:
                    if not self._pending:
                        break
                time.sleep(self.poll_s)
        finally:
            stop.set()
            poller.join()
        with self._pend_lock:
            lost = list(self._pending.values())
            self._pending = {}
        elapsed = time.perf_counter() - t0

        report: Dict = {"elapsed_s": elapsed, "scheduled": n_sched,
                        "max_submit_lag_ms": late_submit_ms,
                        "models": {}}
        for model in sorted(set(scheduled) | set(stats)):
            st = stats.get(model, _ModelStats())
            report["models"][model] = {
                "scheduled": scheduled.get(model, 0),
                "delivered": st.delivered,
                "shed_observed": st.shed,
                "errors": st.errors,
                "lost": sum(1 for m, _, _ in lost if m == model),
                "slo_violations_observed": st.slo_violations,
                "latency_ms": st.hist.summary(),
                "delivered_qps": st.rate.series(),
                "histogram": st.hist.to_dict(),
            }
        return report
