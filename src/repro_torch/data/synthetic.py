"""Synthetic CTR data with Zipfian categorical features, copied from
``repro/data/synthetic.py`` (numpy only): the same ``(cfg, batch, seed,
step)`` gives the same batch in both packages.

Ids are drawn frequency-sorted (rank 0 = most frequent), matching Criteo's
standard preprocessing — this is what makes ``id < hot_rows`` a valid hot
test for the hybrid embedding.

Generation is **stateless**: ``batch(step)`` is a pure function of
``(seed, step)`` so a fault-tolerant trainer can replay any step after
restore without data-pipeline checkpoints.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import RecsysConfig


class SyntheticCTR:

    def __init__(self, cfg: RecsysConfig, batch_size: int, *,
                 seed: int = 0, zipf_a: float = 1.1):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.zipf_a = zipf_a
        #: cat column layout covers EVERY embedding group (primary tables
        #: first, then each extra group's, in declaration order)
        self.tables = tuple(getattr(cfg, "all_tables", cfg.tables))
        self.max_hot = max(t.hotness for t in self.tables)
        # planted logistic model so training has signal
        rng = np.random.default_rng(seed + 7777)
        self._w_dense = rng.normal(size=cfg.num_dense_features) * 0.5
        self._w_cat = [rng.normal(size=t.vocab_size) * 0.5
                       for t in self.tables]

    def _zipf_ids(self, rng, vocab: int, size) -> np.ndarray:
        """Frequency-sorted Zipf draw truncated to [0, vocab)."""
        u = rng.random(size)
        # inverse-CDF of a bounded-Pareto (continuous Zipf) on [1, V+1)
        a = self.zipf_a
        x = (u * ((vocab + 1.0) ** (1 - a) - 1.0) + 1.0) ** (1 / (1 - a))
        return np.clip(np.floor(x).astype(np.int64) - 1, 0, vocab - 1)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        cfg = self.cfg
        b, t, h = self.batch_size, len(self.tables), self.max_hot
        cat = np.full((b, t, h), -1, np.int32)
        score = np.zeros(b)
        for i, tab in enumerate(self.tables):
            ids = self._zipf_ids(rng, tab.vocab_size, (b, tab.hotness))
            cat[:, i, :tab.hotness] = ids
            score += self._w_cat[i][ids].sum(axis=1) / tab.hotness
        dense = rng.lognormal(size=(b, cfg.num_dense_features)) \
            .astype(np.float32)
        dense = np.log1p(dense)  # criteo-style transform
        score += dense @ self._w_dense
        prob = 1.0 / (1.0 + np.exp(-(score - score.mean())))
        label = (rng.random(b) < prob).astype(np.float32)
        return {"dense": dense, "cat": cat, "label": label}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
