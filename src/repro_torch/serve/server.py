"""Batched inference server backed by the HPS (counterpart of
``repro/serve/server.py``), plus the deployment-bundle writer.

Request flow (paper Figure 2): requests queue up, a batcher coalesces up
to ``max_batch`` rows, the HPS resolves the pooled embeddings on the
device (L1 -> L2 -> L3) and the dense net computes the logits; the sigmoid
is applied after the dense net, outside it, as in the reference.

Engines: ``"stream"`` (default) feeds coalesced request groups through
``HPS.lookup_stream(materialize=False)``: while group *i-1*'s prediction
copies to the host, group *i*'s gathers and dense net run on the device
and group *i+1*'s index probes run on the HPS host workers; the one host
sync per group is the prediction itself. ``"sync"`` drains a group and
runs one blocking :meth:`InferenceServer.predict` per group. Both give the
same predictions: every lookup plan gathers from its own payload snapshot.

Admission control, ``stage_sync``, refresh ticks and ``MultiModelServer``
are later slices (ROADMAP "Open items", "The rest of the serving
engine").
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import (
    HPSConfig, hps_config_to_dict, recsys_config_hash,
)
from repro_torch.core.hps.hps import HPS
from repro_torch.core.hps.persistent_db import PersistentDB

ENGINES = ("stream", "sync")


class ServerOverloaded(Exception):
    """Typed rejection delivered to a request handle instead of a
    prediction: the server was closed before it could serve the request."""


class _Req(NamedTuple):
    dense: np.ndarray
    cat: np.ndarray
    done: "queue.Queue"
    t_enq: float


class LatencyWindow:
    """The most recent ``size`` per-group latencies (ms), bounded memory;
    the caller owns the locking."""

    def __init__(self, size: int = 100_000):
        self._ms: deque = deque(maxlen=size)

    def record(self, ms: float) -> None:
        self._ms.append(ms)

    def reset(self) -> None:
        self._ms.clear()

    @property
    def count(self) -> int:
        return len(self._ms)

    def summary(self) -> Dict[str, float]:
        if not self._ms:
            return {}
        a = np.asarray(self._ms, np.float64)
        p50, p95, p99, p999 = np.percentile(a, [50, 95, 99, 99.9])
        return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
                "p999": float(p999), "mean": float(a.mean())}


# ---------------------------------------------------------------------------
# Deployment bundle (counterpart of deploy_from_training and
# api.Model._write_bundle_member)
# ---------------------------------------------------------------------------

def deploy_tables(tables: Dict[str, np.ndarray], pdb: PersistentDB,
                  model_name: str) -> None:
    """Write logical embedding tables (``name -> [V, D]`` f32) into the
    PDB, the ground-truth copy the serving side rebuilds from."""
    for name, full in tables.items():
        full = np.asarray(full, np.float32)
        pdb.create_table(model_name, name, full.shape[0], full.shape[1],
                         initial=full)
    pdb.flush()


def write_bundle(directory: str, graph, dense_params: Dict,
                 tables: Optional[Dict[str, np.ndarray]] = None, *,
                 cache_capacity: int = 4096, max_batch: int = 1024,
                 payload_dtype: str = "f32") -> HPSConfig:
    """Write a single-model serving bundle under ``directory``:
    ``pdb/`` (the tables), ``graph.json``, ``dense.npz`` (the dense
    params under their flat key-paths) and ``ps.json``. The layout and
    formats are the JAX package's, so its ``build_server_from_config``
    serves the bundle too.

    ``graph`` is a :class:`repro_torch.api.Model`; ``dense_params`` its
    param tree (embedding keys, if present, are left out of ``dense.npz``);
    ``tables`` maps table names to ``[V, D]`` arrays. Pass ``tables=None``
    when the PDB under ``directory/pdb`` already holds them (written by
    :func:`deploy_tables` or ``PersistentDB.create_table``), e.g. tables
    too large to hold in memory at once.
    """
    from repro_torch.convert import dense_to_flat
    from repro_torch.train.train_step import split_params
    cfg = graph.to_recsys_config()
    os.makedirs(directory, exist_ok=True)
    pdb_root = os.path.join(directory, "pdb")
    if tables is not None:
        deploy_tables(tables, PersistentDB(pdb_root), graph.name)
    for t in cfg.tables:
        meta = os.path.join(pdb_root, f"{graph.name}__{t.name}.json")
        if not os.path.exists(meta):
            raise FileNotFoundError(f"table {t.name!r} missing from {pdb_root}")
    graph.graph_to_json(os.path.join(directory, "graph.json"))
    np.savez(os.path.join(directory, "dense.npz"),
             **dense_to_flat(split_params(dense_params)[1]))
    hcfg = HPSConfig(
        model=graph.name, pdb_root="pdb", graph_path="graph.json",
        dense_weights_path="dense.npz", tables=cfg.tables,
        cache_capacity=cache_capacity, max_batch=max_batch,
        payload_dtype=payload_dtype, config_hash=recsys_config_hash(cfg))
    with open(os.path.join(directory, "ps.json"), "w") as f:
        json.dump(hps_config_to_dict(hcfg), f, indent=1)
    return hcfg


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class InferenceServer:

    # serving counters and latencies live behind _stats_lock; the closed
    # flag behind _admit_lock; the two are never nested
    _GUARDED_BY = {
        "latency": "_stats_lock",
        "requests_delivered": "_stats_lock",
        "_closed": "_admit_lock",
        "requests_shed": "_admit_lock",
    }

    def __init__(self, model, dense_params: Dict, hps: HPS, *,
                 max_batch: int = 1024, engine: str = "stream"):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {engine!r}")
        self.model = model
        self.hps = hps
        self.device = hps.device
        self.dense_params = dense_params
        self.max_batch = max_batch
        self.engine = engine
        self._stats_lock = threading.Lock()
        self.latency = LatencyWindow()
        self.requests_delivered = 0
        self._admit_lock = threading.Lock()
        self._closed = False
        self.requests_shed = 0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None

    def _record_latency(self, t0: float) -> None:
        with self._stats_lock:
            self.latency.record((time.perf_counter() - t0) * 1e3)

    def _dense_forward(self, dense: np.ndarray,
                       emb: torch.Tensor) -> torch.Tensor:
        """The dense net + sigmoid on the device, shared by both engines."""
        d = torch.from_numpy(np.ascontiguousarray(dense, np.float32)) \
            .to(self.device)
        with torch.no_grad():
            return torch.sigmoid(self.model.apply_dense(
                self.dense_params, d, emb))

    def predict(self, dense: np.ndarray, cat: np.ndarray) -> np.ndarray:
        """One blocking lookup + dense net; returns ``[B]`` probabilities."""
        t0 = time.perf_counter()
        emb = self.hps.lookup(cat, pipelined=len(self.hps.tables) > 1)
        out = self._dense_forward(dense, emb).cpu().numpy()
        self._record_latency(t0)
        return out

    # -- queued/batched path --------------------------------------------------------

    def submit(self, dense: np.ndarray, cat: np.ndarray) -> "queue.Queue":
        """Queue a request; the handle's ``get()`` yields its prediction
        rows, or the exception that failed its group, or
        :class:`ServerOverloaded` if the server was closed."""
        done: queue.Queue = queue.Queue(maxsize=1)
        req = _Req(dense, cat, done, time.perf_counter())
        with self._admit_lock:
            closed = self._closed
            if closed:
                self.requests_shed += 1
            else:
                self._q.put_nowait(req)
        if closed:
            self._put_rejection(req, "server closed")
        return done

    @staticmethod
    def _put_rejection(req: _Req, why: str) -> None:
        try:
            req.done.put_nowait(ServerOverloaded(why))
        except queue.Full:
            pass

    def _coalesce(self, first: _Req):
        """Drain the queue behind ``first`` into one group of at most
        ``max_batch`` rows (the last drained request may overshoot).
        Requests that cannot be concatenated get the error delivered and
        ``None`` comes back."""
        reqs = [first]
        rows = first.dense.shape[0]
        while rows < self.max_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            reqs.append(nxt)
            rows += nxt.dense.shape[0]
        try:
            dense = np.concatenate([r.dense for r in reqs])
            cat = np.concatenate([r.cat for r in reqs])
        except ValueError as exc:
            self._deliver_error(reqs, exc)
            return None
        return reqs, dense, cat

    def _deliver(self, reqs: list, preds: np.ndarray) -> None:
        off = 0
        for r in reqs:
            n = r.dense.shape[0]
            r.done.put(preds[off:off + n])
            off += n
        with self._stats_lock:
            self.requests_delivered += len(reqs)

    @staticmethod
    def _deliver_error(reqs: list, exc: BaseException) -> None:
        for r in reqs:
            try:
                r.done.put_nowait(exc)
            except queue.Full:
                pass

    def _serve_burst_stream(self, first: _Req) -> None:
        """Pipeline one burst: coalesced groups feed ``lookup_stream``,
        each yielded device block feeds the dense net at once, and the
        predictions copy to the host one group behind. The burst ends when
        the queue is empty; the pipeline then drains in order."""
        fifo: deque = deque()   # (reqs, dense, t0) in admission order
        head = [first]

        def cats():
            while True:
                if head:            # always serve the dequeued request
                    nxt = head.pop()
                elif self._stop.is_set():
                    return
                else:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        return
                group = self._coalesce(nxt)
                if group is None:
                    continue
                reqs, dense, cat = group
                if dense.shape[0] == 0:
                    self._deliver(reqs, np.zeros((0,), np.float32))
                    continue
                fifo.append((reqs, dense, time.perf_counter()))
                yield cat

        in_flight: deque = deque()          # (reqs, t0, device preds)
        current = None
        try:
            for emb in self.hps.lookup_stream(cats(), materialize=False):
                current = fifo.popleft()
                out = self._dense_forward(current[1], emb)
                in_flight.append((current[0], current[2], out))
                current = None
                if len(in_flight) > 1:
                    self._materialize(in_flight.popleft())
            while in_flight:
                self._materialize(in_flight.popleft())
        except Exception as exc:            # a failed group fails the
            if current is not None:         # burst: every undelivered
                self._deliver_error(current[0], exc)  # handle gets the
            for reqs, _, _ in in_flight:    # error instead of hanging
                self._deliver_error(reqs, exc)
            for reqs, _, _ in fifo:
                self._deliver_error(reqs, exc)

    def _materialize(self, item) -> None:
        reqs, t0, pred = item
        try:
            preds = pred.cpu().numpy()      # the one host sync per group
        except Exception as exc:
            self._deliver_error(reqs, exc)
            raise
        self._record_latency(t0)
        self._deliver(reqs, preds)

    def _serve_loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if self.engine == "stream":
                self._serve_burst_stream(first)
                continue
            group = self._coalesce(first)
            if group is None:
                continue
            reqs, dense, cat = group
            try:
                preds = self.predict(dense, cat)
            except Exception as exc:        # keep serving; the group's
                self._deliver_error(reqs, exc)  # callers get the error
            else:
                self._deliver(reqs, preds)

    def start(self):
        with self._admit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
        self._worker = threading.Thread(target=self._serve_loop,
                                        daemon=True)
        self._worker.start()

    def stop(self):
        self._stop.set()
        if self._worker:
            self._worker.join()
            self._worker = None
        self._stop.clear()

    def close(self):
        """Refuse new requests, finish the groups already pulled, reject
        every request still queued, and release the HPS host workers."""
        with self._admit_lock:
            self._closed = True
        self.stop()
        shed = 0
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            self._put_rejection(req, "server closed")
            shed += 1
        if shed:
            with self._admit_lock:
                self.requests_shed += shed
        self.hps.close()

    def latency_percentiles(self) -> Dict[str, float]:
        with self._stats_lock:
            return self.latency.summary()

    def reset_latencies(self) -> None:
        with self._stats_lock:
            self.latency.reset()

    def counters(self) -> Dict[str, int]:
        with self._stats_lock:
            out = {"groups_served": self.latency.count,
                   "requests_delivered": self.requests_delivered}
        with self._admit_lock:
            out["requests_shed"] = self.requests_shed
        return out
