"""Freshness probes: publish -> visible-in-prediction lag on a LIVE
server (counterpart of ``repro/online/freshness.py``, copied; the server
is the port's ``InferenceServer``, its ``update_versions()`` the
consumer's applied versions).

The freshness contract has two halves. The storage half: every table's
``Consumer.last_versions`` reaching ``v`` means update ``v`` is applied
to the server's L2/L3 and its L1 rows are queued for refresh. The
serving half: a probe prediction actually changing means the refreshed
rows reached the L1 payload a query reads. :func:`wait_visible` requires
BOTH, and the measured lag (from the publisher's timestamp) is the
paper's update-freshness metric.

Probes go through ``server.submit`` — the real admission/batching path —
so every poll also drives the serving loop's ``_refresh_tick``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np


def probe_prediction(server, dense: np.ndarray, cat: np.ndarray, *,
                     timeout_s: float = 10.0) -> np.ndarray:
    """One probe through the live serving queue."""
    out = server.submit(dense, cat).get(timeout=timeout_s)
    if isinstance(out, Exception):
        raise out
    return np.asarray(out)


def wait_visible(server, publisher, version: int, dense: np.ndarray,
                 cat: np.ndarray, *,
                 baseline: Optional[np.ndarray] = None,
                 tables: Optional[Sequence[str]] = None,
                 timeout_s: float = 30.0,
                 poll_interval_s: float = 0.005) -> Dict:
    """Block until update ``version`` is visible in live predictions.

    Visibility requires the consumer versions of ``tables`` (default:
    whatever tables have consumed updates) to reach ``version`` AND,
    when a ``baseline`` prediction is given, a probe prediction that
    differs from it. Returns ``{"lag_s", "polls", "prediction"}`` with
    the lag measured from ``publisher.publish_time(version)``.
    """
    t0 = publisher.publish_time(version)
    start = time.monotonic()
    deadline = start + timeout_s
    polls = 0
    while True:
        polls += 1
        pred = probe_prediction(server, dense, cat, timeout_s=timeout_s)
        versions = server.update_versions()
        need = list(tables) if tables is not None else list(versions)
        applied = bool(versions) and \
            all(versions.get(t, -1) >= version for t in need)
        changed = baseline is None or not np.allclose(pred, baseline)
        if applied and changed:
            return {"lag_s": time.monotonic() -
                    (t0 if t0 is not None else start),
                    "polls": polls, "prediction": pred}
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"update v{version} not visible after {timeout_s:.0f}s "
                f"(versions={versions}, prediction_changed={changed})")
        time.sleep(poll_interval_s)
