"""Seeded open-loop request generators and the JSONL trace format.

The workload layer answers one question reproducibly: *what arrives at
the server, and when?* A :class:`Workload` is a pure function of
``(WorkloadConfig, {model: ModelShape})`` — iterating it twice, or on
another machine, yields bit-identical arrival times, model choices, id
streams and dense features. On top of that determinism:

- **Open-loop arrivals.** ``poisson`` draws exponential inter-arrival
  gaps at the target qps (the memoryless traffic of a large independent
  user population — the "millions of simulated users" regime);
  ``constant`` paces uniformly. Arrival times are *schedule offsets*:
  the driver submits at those offsets regardless of how the server is
  doing, which is what makes tail latency under overload measurable.
- **Zipf-skewed popularity with hot-set drift.** Ids are drawn by
  popularity RANK (Zipf ``zipf_a``), then mapped rank->id through a
  fixed per-table permutation so the hot set is a scattered, realistic
  id subset. ``drift_per_s`` slides the rank->id mapping over time
  (a fraction of the vocab per second), modeling trending items: the
  ids that are hot at t=0 are cold later, which is exactly the churn
  that ages L1 caches and exercises the refresh path.
- **Multi-model mixes.** ``mix`` weights route each request to one
  ensemble member; shapes come from each member's deployed config.
- **Trace record/replay.** ``record_trace`` writes one JSON object per
  request (schedule offset, model, dense, cat); ``replay_trace`` yields
  them back bit-exactly — a replayed trace IS the workload, so a
  production capture and a synthetic run drive the harness identically.

A copy of ``repro/loadgen/workload.py`` (numpy only): for the same
config and shapes the stream is the reference's bit for bit, and a trace
written by either package replays in the other.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class ModelShape:
    """What one model's requests look like: per-table vocab/hotness and
    the dense feature width. Built from a deployed ``RecsysConfig``."""
    vocab_sizes: Sequence[int]
    hotness: Sequence[int]
    num_dense: int

    @classmethod
    def from_config(cls, cfg) -> "ModelShape":
        return cls(vocab_sizes=tuple(t.vocab_size for t in cfg.tables),
                   hotness=tuple(t.hotness for t in cfg.tables),
                   num_dense=cfg.num_dense_features)

    @property
    def num_tables(self) -> int:
        return len(self.vocab_sizes)

    @property
    def max_hot(self) -> int:
        return max(self.hotness)


@dataclass(frozen=True)
class WorkloadConfig:
    """Everything that determines a workload, hashable and loggable.

    ``qps`` is the *offered* rate — the server sees it whether it keeps
    up or not. ``drift_per_s`` is the fraction of each table's vocab the
    hot set shifts per second (0 = stationary popularity).
    """
    qps: float
    duration_s: float
    rows: int = 8                  # rows per request
    arrival: str = "poisson"       # "poisson" | "constant"
    seed: int = 0
    zipf_a: float = 1.2
    drift_per_s: float = 0.0
    mix: Optional[Dict[str, float]] = None   # model -> weight

    def __post_init__(self):
        if self.arrival not in ("poisson", "constant"):
            raise ValueError(f"arrival must be poisson|constant, "
                             f"got {self.arrival!r}")
        if self.qps <= 0 or self.duration_s <= 0 or self.rows <= 0:
            raise ValueError("qps, duration_s and rows must be positive")
        if self.zipf_a <= 1.0:
            raise ValueError("zipf_a must be > 1")


@dataclass
class Request:
    """One scheduled request: submit ``dense``/``cat`` to ``model`` at
    schedule offset ``t`` seconds after the run starts."""
    t: float
    model: str
    dense: np.ndarray          # [rows, num_dense] float32
    cat: np.ndarray            # [rows, T, maxH] int32, -1 padded


class Workload:
    """Deterministic open-loop request stream over one or more models."""

    def __init__(self, cfg: WorkloadConfig,
                 shapes: Dict[str, ModelShape]):
        if not shapes:
            raise ValueError("need at least one model shape")
        self.cfg = cfg
        self.shapes = dict(shapes)
        names = sorted(self.shapes)
        if cfg.mix is not None:
            unknown = sorted(set(cfg.mix) - set(names))
            if unknown:
                raise ValueError(f"mix names unknown models {unknown}; "
                                 f"shapes declare {names}")
            names = sorted(cfg.mix)
            weights = np.asarray([cfg.mix[n] for n in names], np.float64)
            if (weights <= 0).any():
                raise ValueError("mix weights must be positive")
        else:
            weights = np.ones(len(names), np.float64)
        self._names = names
        self._weights = weights / weights.sum()
        # fixed rank->id permutation per (model, table): the hot ranks
        # land on a scattered id subset, and drift slides along it
        self._perms = {
            name: [np.random.default_rng((cfg.seed, mi, ti, 0xC0FFEE))
                   .permutation(v)
                   for ti, v in enumerate(self.shapes[name].vocab_sizes)]
            for mi, name in enumerate(names)}

    # -- sampling helpers ---------------------------------------------------

    def _zipf_ranks(self, rng, vocab: int, size) -> np.ndarray:
        """Popularity ranks (0 = hottest), Zipf-drawn, folded into
        [0, vocab) like the repo's other Zipf streams."""
        return ((rng.zipf(self.cfg.zipf_a, size) - 1) % vocab) \
            .astype(np.int64)

    def _ids(self, name: str, ti: int, rng, t: float,
             size) -> np.ndarray:
        """rank -> drifted slot -> permuted id for one table."""
        vocab = self.shapes[name].vocab_sizes[ti]
        ranks = self._zipf_ranks(rng, vocab, size)
        shift = int(self.cfg.drift_per_s * t * vocab)
        return self._perms[name][ti][(ranks + shift) % vocab]

    def _request(self, t: float, name: str, rng) -> Request:
        shape = self.shapes[name]
        b = self.cfg.rows
        cat = np.full((b, shape.num_tables, shape.max_hot), -1, np.int32)
        for ti, h in enumerate(shape.hotness):
            cat[:, ti, :h] = self._ids(name, ti, rng, t, (b, h))
        dense = np.log1p(rng.lognormal(size=(b, shape.num_dense))) \
            .astype(np.float32)
        return Request(t=t, model=name, dense=dense, cat=cat)

    # -- the stream ---------------------------------------------------------

    def requests(self) -> Iterator[Request]:
        """Yield the full scheduled stream, in arrival order. One RNG
        drives arrivals, routing and payloads sequentially, so the
        stream is a pure function of (cfg, shapes)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, 0xA221))
        t = 0.0
        while True:
            if cfg.arrival == "poisson":
                t += rng.exponential(1.0 / cfg.qps)
            else:
                t += 1.0 / cfg.qps
            if t > cfg.duration_s:
                return
            name = self._names[rng.choice(len(self._names),
                                          p=self._weights)]
            yield self._request(t, name, rng)

    def __iter__(self) -> Iterator[Request]:
        return self.requests()


# ---------------------------------------------------------------------------
# trace record / replay (JSONL)
# ---------------------------------------------------------------------------
#
# One JSON object per line. Floats survive the round trip bit-exactly:
# json emits shortest-round-trip reprs, and every float32 is exactly
# representable as (and recoverable from) a python float.

TRACE_FORMAT = "repro-loadtrace-v1"


def record_trace(path: str, requests: Iterable[Request]) -> int:
    """Write the request stream as JSONL; returns the request count."""
    n = 0
    with open(path, "w") as f:
        f.write(json.dumps({"format": TRACE_FORMAT}) + "\n")
        for r in requests:
            f.write(json.dumps({
                "t": r.t, "model": r.model,
                "dense": [[float(x) for x in row] for row in r.dense],
                "cat": r.cat.tolist(),
            }) + "\n")
            n += 1
    return n


def replay_trace(path: str) -> Iterator[Request]:
    """Yield the recorded stream back, bit-exact with what was written."""
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("format") != TRACE_FORMAT:
            raise ValueError(f"{path}: not a {TRACE_FORMAT} trace "
                             f"(header {header})")
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            yield Request(t=d["t"], model=d["model"],
                          dense=np.asarray(d["dense"], np.float32),
                          cat=np.asarray(d["cat"], np.int32))
