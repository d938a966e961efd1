"""Frequency statistics for hot/cold splitting (hybrid sparse embedding).

HugeCTR's hybrid embedding decides hot vs cold per category by access
frequency. We keep the statistics host-side (numpy) — they are collected
from the data pipeline, not from device code — and produce either

  * a *remap* (old id -> frequency-rank id) so that ``id < hot_rows`` is the
    hot test on device (branch-free on the device), or
  * a boolean hot-set for data that is already frequency-sorted (Criteo-style
    preprocessing emits ids sorted by frequency, which is what our synthetic
    generator produces too).

A copy of ``repro/core/embedding/frequency.py`` (numpy only, no framework).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class FrequencyStats:
    """Streaming per-table id frequency counters."""

    def __init__(self, vocab_sizes: Sequence[int]):
        self.counts = [np.zeros(v, np.int64) for v in vocab_sizes]

    def update(self, ids_batch: np.ndarray) -> None:
        """``ids_batch``: ``[B, T, H]`` with -1 padding."""
        for t, c in enumerate(self.counts):
            ids = ids_batch[:, t, :].reshape(-1)
            ids = ids[ids >= 0]
            np.add.at(c, ids, 1)

    def hot_rows(self, table: int, hot_fraction: float) -> int:
        v = len(self.counts[table])
        return max(0, min(v, int(round(v * hot_fraction))))

    def remap(self, table: int) -> np.ndarray:
        """old id -> frequency-rank id (rank 0 = most frequent)."""
        order = np.argsort(-self.counts[table], kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return inv

    def coverage(self, table: int, hot_fraction: float) -> float:
        """Fraction of accesses served by the hot set (cache-hit estimate)."""
        c = np.sort(self.counts[table])[::-1]
        k = self.hot_rows(table, hot_fraction)
        tot = c.sum()
        return float(c[:k].sum() / tot) if tot else 0.0


def apply_remap(ids: np.ndarray, remaps: Sequence[Optional[np.ndarray]]
                ) -> np.ndarray:
    """Host-side id remap, ``ids [B, T, H]`` (-1 preserved)."""
    out = ids.copy()
    for t, r in enumerate(remaps):
        if r is None:
            continue
        col = ids[:, t, :]
        out[:, t, :] = np.where(col >= 0, r[np.clip(col, 0, None)], -1)
    return out
