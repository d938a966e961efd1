"""Batched inference server backed by the HPS (counterpart of
``repro/serve/server.py``), plus the deployment-bundle writer.

Request flow (paper Figure 2): requests queue up, a batcher coalesces up
to ``max_batch`` rows, the HPS resolves the pooled embeddings on the
device (L1 -> L2 -> L3) and the dense net computes the logits; the sigmoid
is applied after the dense net, outside it, as in the reference.

Wide models (WDL, DeepFM, a graph with a wide branch) serve through a
second HPS, ``wide_hps``, over the tables' dim-1 twins, which read the
primary tables' ``cat`` columns; an N-group model serves each extra group
through its own HPS (``extra_hps``, by group name), which reads the
group's own ``cat`` columns (``RecsysModel.group_columns``). The dense
net takes every pooled block. ``hotness`` (ids per table, every ``cat``
column in group order) serves ragged ``[B, sum(hotness)]`` requests on a
single-group server, or masks ``[B, T, H]`` columns beyond each table's
hotness; it is sliced per group alongside ``cat``.

Engines, all giving the same predictions bit for bit (every lookup plan
gathers from its own payload snapshot, and every engine runs the same
launches and the same dense forward): ``"stream"`` (default) feeds
coalesced request groups through ``HPS.lookup_stream(materialize=False)``
(one stream per HPS, each fed the same groups, cut to its columns): while
group *i-1*'s prediction copies to the host, group *i*'s gathers and
dense net run on the device and group *i+1*'s index probes run on the HPS
host workers; the one host sync per group is the prediction itself.
``"sync"`` drains a group and runs one blocking :meth:`predict` per
group. ``"stage_sync"`` waits for every device stage before the next host
stage (``HPS.lookup_stage_sync``, then the dense net): the no-overlap
engine the others are measured against.

ADMISSION CONTROL (off by default, so the bare server serves everything
it is given): a server constructed, or configured through
:meth:`InferenceServer.set_admission`, with ``queue_depth`` and/or
``slo_ms`` becomes an admission-controlled endpoint:

- **Bounded queue, typed shedding.** ``submit`` beyond ``queue_depth``
  queued requests, or after ``close()``, never enqueues: the handle
  receives :class:`ServerOverloaded` at once (``requests_shed``).
- **Deadline-aware batching.** With ``slo_ms`` declared, the batcher
  sizes each group from the OLDEST queued request's remaining slack
  (:func:`deadline_batch_target`, over an EWMA of the observed ms per
  row), and a request whose deadline passed before it was drained is
  shed (``requests_expired``) instead of served late. Delivered requests
  that still missed the SLO count in ``slo_violations``.
  ``deadline_batching=False`` is the fixed-coalescing arm: it serves
  everything it admitted, however late.
- **close() never strands a handle.** It refuses new admissions,
  finishes the groups already pulled, then rejects every queued handle.

The serve loop also drives update propagation (no bare timer thread):
between pipeline stages, after each ``sync`` / ``stage_sync`` group and
while idle it polls the message bus into L2/L3 (marking the touched L1
rows dirty) and drains one bounded, hotness-ordered refresh chunk of
every HPS (``refresh_budget`` rows a table); a periodic
``refresh_poll_s`` full-mark sweeps rows whose updates arrived out of
band, and the ``on_tick`` hook (the ensemble's budget rebalancer) runs at
the end of every tick. ``update_versions`` reports the newest update
version applied per table, the serving half of the freshness contract.

:class:`MultiModelServer` fronts several models from one storage
backend: per-model serve loops and L1 caches over a shared VolatileDB
(model-scoped keys), a shared PersistentDB and a shared message bus, the
ensemble deployment unit of the GPU-specialized inference parameter
server (arXiv 2210.08804), rebuilt by ``launch.serve.
build_server_from_config`` from one ensemble ``ps.json``.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from collections import deque
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.configs.base import (
    HPSConfig, hps_config_to_dict, recsys_config_hash,
)
from repro_torch.core.hps.hps import HPS
from repro_torch.core.hps.message_bus import MessageBus
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.core.hps.volatile_db import VolatileDB
from repro_torch.loadgen.metrics import LatencyHistogram

ENGINES = ("stream", "sync", "stage_sync")


class ServerOverloaded(Exception):
    """Typed rejection delivered to a request handle instead of a
    prediction: the admission queue was full, the request's deadline
    expired before it could be served, or the server was closed. A shed
    is an expected overload outcome, not a serving fault."""


def deadline_batch_target(oldest_age_ms: float, slo_ms: float,
                          max_batch: int,
                          service_ms_per_row: Optional[float]) -> int:
    """Rows a forming request group may grow to before its OLDEST
    member risks the latency SLO (the reference's rule).

    The returned ``target`` satisfies ``oldest_age_ms + target *
    service_ms_per_row <= slo_ms`` whenever an estimate exists, or is the
    floor ``1`` (the oldest request always ships). With no estimate yet
    (a cold server) the full ``max_batch`` is allowed until the deadline
    itself has passed.
    """
    if oldest_age_ms >= slo_ms:
        return 1
    if service_ms_per_row is None or service_ms_per_row <= 0:
        return max_batch
    slack = slo_ms - oldest_age_ms
    return max(1, min(max_batch, int(slack / service_ms_per_row)))


class _Req(NamedTuple):
    """One queued request: arrays, the caller's handle, and the admission
    time the SLO accounting measures from."""
    dense: np.ndarray
    cat: np.ndarray
    done: "queue.Queue"
    t_enq: float


# ---------------------------------------------------------------------------
# Deployment bundle (counterpart of deploy_from_training and
# api.Model._write_bundle_member / _build_server)
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


def trained_tables(model, params: Dict) -> Dict[str, np.ndarray]:
    """Every collection's logical ``[V, D]`` f32 tables by name: the deep
    tables, the dim-1 ``*_wide`` twins of a wide model and each extra
    group's. ``model`` is a ``RecsysModel``, ``params`` its param tree."""
    tables: Dict[str, np.ndarray] = {}
    for key, coll in model.collections().items():
        tables.update(coll.logical_tables(params[key]))
    return tables


def deploy_from_training(model, params: Dict, pdb: PersistentDB,
                         model_name: str) -> None:
    """Export trained embedding tables into the PDB (ground truth copy).

    EVERY collection exports: the deep tables, the dim-1 ``*_wide``
    twins of wide models (wdl/deepfm), and each extra N-group
    collection's tables — so the serving side can stand up one HPS per
    dim class from the PDB alone."""
    deploy_tables(trained_tables(model, params), pdb, model_name)


def write_bundle_member(pdb: PersistentDB, bundle_dir: str, sub: str,
                        graph, dense_params: Dict,
                        tables: Optional[Dict[str, np.ndarray]] = None, *,
                        cache_capacity: int = 4096, cache_shards: int = 1,
                        refresh_budget: int = 512, max_batch: int = 1024,
                        payload_dtype: str = "f32") -> HPSConfig:
    """Export one model into a (possibly shared) bundle: its tables into
    ``pdb``, ``graph.json`` and ``dense.npz`` under ``bundle_dir/sub``;
    returns the relocatable HPSConfig, its paths relative to
    ``bundle_dir`` (the reference's ``Model._write_bundle_member``).

    ``graph`` is a :class:`repro_torch.api.Model`; ``dense_params`` its
    param tree (embedding keys, if present, are left out of
    ``dense.npz``); ``tables`` maps table names to ``[V, D]`` arrays, a
    wide model's ``<name>_wide`` ``[V, 1]`` twins and every extra group's
    tables included. Pass ``tables=None`` when ``pdb`` already holds them
    (written by :func:`deploy_tables` or ``PersistentDB.create_table``),
    e.g. tables too large to hold in memory at once.
    """
    from repro_torch.convert import dense_to_flat
    from repro_torch.models.recsys.model import has_wide, wide_tables
    from repro_torch.train.train_step import split_params
    cfg = graph.to_recsys_config()
    wide = has_wide(cfg)
    out_dir = os.path.join(bundle_dir, sub) if sub else bundle_dir
    os.makedirs(out_dir, exist_ok=True)
    if tables is not None:
        deploy_tables(tables, pdb, graph.name)
    for t in cfg.all_tables + (wide_tables(cfg) if wide else ()):
        meta = os.path.join(pdb.root, f"{graph.name}__{t.name}.json")
        if not os.path.exists(meta):
            raise FileNotFoundError(f"table {t.name!r} missing from "
                                    f"{pdb.root}")
    graph.graph_to_json(os.path.join(out_dir, "graph.json"))
    np.savez(os.path.join(out_dir, "dense.npz"),
             **dense_to_flat(split_params(dense_params)[1]))
    rel = (lambda p: f"{sub}/{p}" if sub else p)
    return HPSConfig(
        model=graph.name, pdb_root="pdb", graph_path=rel("graph.json"),
        dense_weights_path=rel("dense.npz"), tables=cfg.tables, wide=wide,
        cache_capacity=cache_capacity, cache_shards=cache_shards,
        refresh_budget=refresh_budget, max_batch=max_batch,
        payload_dtype=payload_dtype, config_hash=recsys_config_hash(cfg))


def write_bundle(directory: str, graph, dense_params: Dict,
                 tables: Optional[Dict[str, np.ndarray]] = None, *,
                 cache_capacity: int = 4096, cache_shards: int = 1,
                 refresh_budget: int = 512, max_batch: int = 1024,
                 payload_dtype: str = "f32") -> HPSConfig:
    """Write a single-model serving bundle under ``directory``: ``pdb/``
    (the tables), ``graph.json``, ``dense.npz`` (the dense params under
    their flat key-paths) and ``ps.json``
    (:func:`write_bundle_member` with the bundle's own ``ps.json``). The
    layout and formats are the JAX package's, so its
    ``build_server_from_config`` serves the bundle too. ``cache_shards``
    (the L1 striping) and ``refresh_budget`` (rows a refresh chunk) go
    into ``ps.json`` as the reference writes them."""
    os.makedirs(directory, exist_ok=True)
    hcfg = write_bundle_member(
        PersistentDB(os.path.join(directory, "pdb")), directory, "", graph,
        dense_params, tables, cache_capacity=cache_capacity,
        cache_shards=cache_shards, refresh_budget=refresh_budget,
        max_batch=max_batch, payload_dtype=payload_dtype)
    with open(os.path.join(directory, "ps.json"), "w") as f:
        json.dump(hps_config_to_dict(hcfg), f, indent=1)
    return hcfg


def build_server(model, pdb: PersistentDB, hcfg: HPSConfig, dense: Dict, *,
                 vdb: Optional[VolatileDB] = None,
                 bus: Optional[MessageBus] = None,
                 cache_mesh=None) -> "InferenceServer":
    """Stand up one model's HPSes + :class:`InferenceServer` over storage
    that already holds its tables: the one place the serving stack is
    wired (the reference's ``Model._build_server``), shared by the
    in-process ``deploy`` / ``deploy_ensemble`` and the ``ps.json``
    rebuild. ``model`` is the lowered ``RecsysModel`` (its device is the
    server's), ``dense`` its dense param tree. The primary tables, a wide
    model's dim-1 twins and each extra group get one HPS each, all over
    ``pdb``, the caller's VolatileDB and message bus, with the bundle's L1
    capacity, striping and payload type; the stripes across the devices
    of ``cache_mesh`` when one is given."""
    from repro_torch.models.recsys.model import wide_tables
    cfg = model.cfg
    if hcfg.wide != (model.wide is not None):
        raise ValueError(f"model {hcfg.model!r}: ps.json says wide="
                         f"{hcfg.wide} for a {cfg.model} graph")

    def hps(tables):
        return HPS(hcfg.model, tables, pdb, vdb=vdb, bus=bus,
                   cache_capacity=hcfg.cache_capacity,
                   cache_shards=hcfg.cache_shards,
                   payload_dtype=hcfg.payload_dtype, device=model.device,
                   cache_mesh=cache_mesh)

    return InferenceServer(
        model, dense, hps(cfg.tables),
        wide_hps=hps(wide_tables(cfg)) if hcfg.wide else None,
        extra_hps={g.name: hps(g.tables) for g in cfg.extra_groups},
        max_batch=hcfg.max_batch, refresh_budget=hcfg.refresh_budget)


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class InferenceServer:

    # serving counters, the latency histogram and the batcher's estimate
    # are written by the serve loop and read by stats callers, so they
    # live behind _stats_lock; the admission gate (closed flag + shed
    # counter) is touched from every SUBMITTING thread, so it has its own
    # lock; the two are never nested
    _GUARDED_BY = {
        "updates_applied": "_stats_lock",
        "rows_refreshed": "_stats_lock",
        "latency_hist": "_stats_lock",
        "requests_delivered": "_stats_lock",
        "requests_expired": "_stats_lock",
        "slo_violations": "_stats_lock",
        "_service_ms_per_row": "_stats_lock",
        "_closed": "_admit_lock",
        "requests_shed": "_admit_lock",
    }

    def __init__(self, model, dense_params: Dict, hps: Optional[HPS], *,
                 max_batch: int = 1024,
                 wide_hps: Optional[HPS] = None,
                 extra_hps: Optional[Dict[str, HPS]] = None,
                 hotness: Optional[Sequence[int]] = None,
                 refresh_budget: int = 512,
                 refresh_poll_s: Optional[float] = None,
                 engine: str = "stream",
                 queue_depth: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 deadline_batching: bool = True):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {engine!r}")
        self.model = model
        self.hps = hps
        #: the HPS of a wide model's dim-1 twins (the primary columns)
        self.wide_hps = wide_hps
        #: one HPS per extra group of an N-group model, by group name
        self.extra_hps: Dict[str, HPS] = dict(extra_hps or {})
        #: ``cat`` column span per lookup key; empty for single-group
        #: models, whose every lookup reads the whole ``cat`` block
        self._cols: Dict[str, Tuple[int, int]] = \
            dict(model.group_columns()) if self.extra_hps else {}
        #: ids per table over every ``cat`` column in group order,
        #: forwarded to ``HPS.lookup`` (validated there), sliced per group
        self.hotness = list(hotness) if hotness is not None else None
        self.device = hps.device if hps is not None else None
        self.dense_params = dense_params
        self.max_batch = max_batch
        self.engine = engine
        #: rows re-pulled per table and refresh chunk, one chunk a tick
        self.refresh_budget = refresh_budget
        #: period of the full-mark sweep (None = only bus-marked rows)
        self.refresh_poll_s = refresh_poll_s
        #: admission policy (None = unbounded / no SLO)
        self.queue_depth = queue_depth
        self.slo_ms = slo_ms
        self.deadline_batching = deadline_batching
        self._last_poll = time.monotonic()
        self._stats_lock = threading.Lock()
        self.updates_applied = 0
        self.rows_refreshed = 0
        #: bounded-memory per-group latency store (mergeable histogram)
        self.latency_hist = LatencyHistogram()
        self.requests_delivered = 0
        self.requests_expired = 0
        self.slo_violations = 0
        #: EWMA of the observed ms per delivered row, which the deadline
        #: batcher cuts groups by (None until the first group)
        self._service_ms_per_row: Optional[float] = None
        self._admit_lock = threading.Lock()
        self._closed = False
        self.requests_shed = 0
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth or 0)
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        #: control-plane hook run at the end of every refresh tick (the
        #: ensemble's budget rebalancer registers itself here); it runs on
        #: the serve loop between pipeline stages, so it must be cheap or
        #: rate-limit itself
        self.on_tick: Optional[Callable[[], None]] = None

    def set_admission(self, *, queue_depth: Optional[int] = None,
                      slo_ms: Optional[float] = None,
                      deadline_batching: bool = True) -> None:
        """Declare (or replace) the admission policy on a stopped server:
        the request queue is swapped for one with the new bound, so this
        must run before ``start()`` or concurrent submits. Requests
        already queued carry over; any overflow beyond the new bound is
        shed with the typed rejection."""
        if self._worker is not None:
            raise RuntimeError("set_admission() requires a stopped "
                               "server: call it before start()")
        self.queue_depth = queue_depth
        self.slo_ms = slo_ms
        self.deadline_batching = deadline_batching
        newq: queue.Queue = queue.Queue(maxsize=queue_depth or 0)
        shed = 0
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            try:
                newq.put_nowait(req)
            except queue.Full:
                self._put_rejection(req, "queue bound shrank")
                shed += 1
        self._q = newq
        if shed:
            with self._admit_lock:
                self.requests_shed += shed

    def _record_latency(self, t0: float, rows: int = 0) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        with self._stats_lock:
            self.latency_hist.record(ms)
            if rows > 0:        # feed the deadline batcher's estimate
                obs = ms / rows
                self._service_ms_per_row = obs \
                    if self._service_ms_per_row is None \
                    else 0.8 * self._service_ms_per_row + 0.2 * obs

    def _hpses(self) -> List[Tuple[str, HPS]]:
        """``(lookup key, HPS)`` for every HPS, in the order the blocks
        feed the dense net: the primary, the wide twins (which read the
        primary columns, so share its key), then each extra group."""
        out = [] if self.hps is None else [("embedding", self.hps)]
        if self.wide_hps is not None:
            out.append(("embedding", self.wide_hps))
        out += [(f"embedding@{name}", h)
                for name, h in self.extra_hps.items()]
        return out

    def _group_cat(self, cat: np.ndarray, key: str) -> np.ndarray:
        """The ``cat`` columns of one lookup key (the whole block for a
        single-group model). An N-group server slices ``cat[:, lo:hi, :]``
        as the reference does, so it takes ``[B, T, H]`` requests only."""
        if not self._cols:
            return cat
        if np.ndim(cat) != 3:
            raise ValueError(
                f"an N-group server takes cat [B, T, H]; got shape "
                f"{np.shape(cat)} (ragged [B, sum(hotness)] requests are "
                "served by single-group models, as in the reference)")
        lo, hi = self._cols[key]
        return cat[:, lo:hi, :]

    def _group_hot(self, key: str) -> Optional[List[int]]:
        if not self._cols or self.hotness is None:
            return self.hotness
        lo, hi = self._cols[key]
        return self.hotness[lo:hi]

    def _dense_forward(self, dense: np.ndarray,
                       blocks: List[torch.Tensor]) -> torch.Tensor:
        """The dense net + sigmoid on the device, shared by every engine
        so their outputs are bit-identical; ``blocks`` are the pooled
        blocks in :meth:`_hpses` order."""
        d = devmod.to_device(np.asarray(dense, np.float32), self.device)
        emb, rest = blocks[0], list(blocks[1:])
        wide = rest.pop(0) if self.wide_hps is not None else None
        extras = dict(zip(self.extra_hps, rest)) or None
        with torch.no_grad():
            return torch.sigmoid(self.model.apply_dense(
                self.dense_params, d, emb, wide, extras=extras))

    def predict(self, dense: np.ndarray, cat: np.ndarray) -> np.ndarray:
        """One blocking lookup per HPS (the wide twins read the primary
        tables' ``cat`` columns, each extra group its own) + dense net;
        returns ``[B]`` probabilities."""
        t0 = time.perf_counter()
        blocks = [h.lookup(self._group_cat(cat, key), self._group_hot(key),
                           pipelined=len(h.tables) > 1)
                  for key, h in self._hpses()]
        out = self._dense_forward(dense, blocks).cpu().numpy()
        self._record_latency(t0, rows=dense.shape[0])
        return out

    def _predict_stage_sync(self, dense: np.ndarray,
                            cat: np.ndarray) -> np.ndarray:
        """The no-overlap engine: every HPS's device stages are waited
        for before the next host stage (``HPS.lookup_stage_sync``), and
        the dense net before the copy to the host. The launches and the
        dense forward are :meth:`predict`'s, so the result is too."""
        t0 = time.perf_counter()
        blocks = [h.lookup_stage_sync(self._group_cat(cat, key),
                                      self._group_hot(key))
                  for key, h in self._hpses()]
        out = self._dense_forward(dense, blocks)
        devmod.synchronize(self.device)
        out = out.cpu().numpy()
        self._record_latency(t0, rows=dense.shape[0])
        return out

    # -- refresh scheduling (runs on the serve loop, between batches) -------------

    def _refresh_tick(self) -> None:
        """One serving-loop tick of update propagation over every HPS:
        bus -> L2/L3 (+ dirty marks), the periodic full-mark sweep, and
        ONE bounded hotness-ordered refresh chunk, never a stop-the-world
        re-pull; then the ``on_tick`` hook. Safe anywhere between pipeline
        stages: in-flight plans hold their own payload snapshots, so a
        refresh scatter never tears a query's view."""
        sweep = False
        if self.refresh_poll_s is not None:
            now = time.monotonic()
            if now - self._last_poll >= self.refresh_poll_s:
                self._last_poll = now
                sweep = True
        applied = refreshed = 0            # the bus/refresh IO runs
        for _, hps in self._hpses():       # unlocked; the counters move
            if hps.consumer is not None:   # in one step below
                applied += hps.apply_updates()
            if sweep:
                hps.schedule_refresh()
            if hps.refresh_backlog():
                refreshed += hps.refresh_step(self.refresh_budget)
        if applied or refreshed:
            with self._stats_lock:
                self.updates_applied += applied
                self.rows_refreshed += refreshed
        if self.on_tick is not None:
            self.on_tick()

    def update_versions(self) -> Dict[str, int]:
        """Highest online-update version applied per table, across every
        HPS of this server: the serving half of the freshness contract (a
        freshness probe polls this until the published version lands)."""
        out: Dict[str, int] = {}
        for _, hps in self._hpses():
            if hps.consumer is not None:
                out.update(hps.consumer.last_versions)
        return out

    # -- queued/batched path --------------------------------------------------------

    def submit(self, dense: np.ndarray, cat: np.ndarray) -> "queue.Queue":
        """Queue a request; the handle's ``get()`` yields its prediction
        rows, or the exception that failed its group. A full admission
        queue or a closed server delivers :class:`ServerOverloaded` to the
        handle at once: the caller never blocks on a request the server
        already decided not to serve."""
        done: queue.Queue = queue.Queue(maxsize=1)
        req = _Req(dense, cat, done, time.perf_counter())
        rejection = None
        with self._admit_lock:
            if self._closed:
                self.requests_shed += 1
                rejection = "server closed"
            else:
                try:
                    self._q.put_nowait(req)
                except queue.Full:
                    self.requests_shed += 1
                    rejection = (f"admission queue full "
                                 f"(depth {self.queue_depth})")
        if rejection is not None:
            self._put_rejection(req, rejection)
        return done

    @staticmethod
    def _put_rejection(req: _Req, why: str) -> None:
        try:
            req.done.put_nowait(ServerOverloaded(why))
        except queue.Full:
            pass

    def _expired(self, req: _Req) -> bool:
        """Deadline shedding applies only with an SLO declared AND
        deadline batching on: the fixed-coalescing arm serves everything
        it admitted, however late."""
        if self.slo_ms is None or not self.deadline_batching:
            return False
        return (time.perf_counter() - req.t_enq) * 1e3 >= self.slo_ms

    def _batch_target(self, first: _Req) -> int:
        if self.slo_ms is None or not self.deadline_batching:
            return self.max_batch
        age_ms = (time.perf_counter() - first.t_enq) * 1e3
        with self._stats_lock:
            est = self._service_ms_per_row
        return deadline_batch_target(age_ms, self.slo_ms, self.max_batch,
                                     est)

    def _coalesce(self, first: _Req
                  ) -> Optional[Tuple[list, np.ndarray, np.ndarray]]:
        """Drain the queue behind ``first`` into one group (one device
        batch), bounded by ``max_batch`` rows or, with an SLO declared, by
        the oldest request's remaining slack (the last drained request
        may overshoot the target: a drained request is never re-queued).
        An expired head is shed with the typed rejection instead of
        served late. Requests that cannot be concatenated get the error
        delivered and ``None`` comes back."""
        while self._expired(first):
            self._put_rejection(first, f"deadline expired "
                                       f"(slo {self.slo_ms}ms)")
            with self._stats_lock:
                self.requests_expired += 1
            try:
                first = self._q.get_nowait()
            except queue.Empty:
                return None
        reqs = [first]
        rows = first.dense.shape[0]
        target = self._batch_target(first)
        while rows < target:
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
        now = time.perf_counter()
        violations = 0
        for r in reqs:
            n = r.dense.shape[0]
            r.done.put(preds[off:off + n])
            off += n
            if self.slo_ms is not None and \
                    (now - r.t_enq) * 1e3 > self.slo_ms:
                violations += 1
        with self._stats_lock:
            self.requests_delivered += len(reqs)
            self.slo_violations += violations

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

        # one stream per HPS, each fed the same groups cut to its
        # columns (the wide twins read the primary ones), and zip binds
        # each group's blocks, in order, before its one sync
        def cut(src, key):
            for c in src:
                yield self._group_cat(c, key)

        hpses = self._hpses()
        streams = [h.lookup_stream(cut(src, key), self._group_hot(key),
                                   materialize=False)
                   for (key, h), src in
                   zip(hpses, itertools.tee(cats(), len(hpses)))]
        in_flight: deque = deque()          # (reqs, t0, device preds)
        current = None
        try:
            for blocks in zip(*streams):
                current = fifo.popleft()
                out = self._dense_forward(current[1], blocks)
                in_flight.append((current[0], current[2], out))
                current = None
                self._refresh_tick()        # between pipeline stages
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
        self._record_latency(t0, rows=len(preds))
        self._deliver(reqs, preds)

    def _serve_loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                self._refresh_tick()        # idle: drain the backlog
                continue
            if self.engine == "stream":
                self._serve_burst_stream(first)
                continue
            group = self._coalesce(first)
            if group is None:               # errors already delivered
                self._refresh_tick()
                continue
            reqs, dense, cat = group
            try:
                if self.engine == "stage_sync":
                    preds = self._predict_stage_sync(dense, cat)
                else:
                    preds = self.predict(dense, cat)
            except Exception as exc:        # keep serving; the group's
                self._deliver_error(reqs, exc)  # callers get the error
            else:
                self._deliver(reqs, preds)
            self._refresh_tick()            # interleave with serving

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
        every request still queued, and release the HPS host workers:
        after ``close()`` returns, every handle ever issued holds a
        prediction or an exception."""
        with self._admit_lock:
            self._closed = True
        self.stop()
        shed = 0
        while True:         # no racing producers: _closed gates submit
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            self._put_rejection(req, "server closed")
            shed += 1
        if shed:
            with self._admit_lock:
                self.requests_shed += shed
        for _, h in self._hpses():
            h.close()

    def latency_percentiles(self) -> Dict[str, float]:
        with self._stats_lock:
            hist = self.latency_hist.snapshot()
        if hist.count == 0:
            return {}
        s = hist.summary()
        return {"p50": s["p50"], "p95": s["p95"], "p99": s["p99"],
                "p999": s["p999"], "mean": s["mean"]}

    def reset_latencies(self) -> None:
        """Drop the latency samples (a benchmark's warm-up reset)."""
        with self._stats_lock:
            self.latency_hist.reset()

    def reset_serving_stats(self) -> None:
        """Zero the latency samples AND the admission counters, between a
        warm-up and a measured phase."""
        with self._stats_lock:
            self.latency_hist.reset()
            self.requests_delivered = 0
            self.requests_expired = 0
            self.slo_violations = 0
        with self._admit_lock:
            self.requests_shed = 0

    def counters(self) -> Dict[str, int]:
        """Lock-consistent snapshot of the serving counters."""
        with self._stats_lock:
            out = {"updates_applied": self.updates_applied,
                   "rows_refreshed": self.rows_refreshed,
                   "groups_served": self.latency_hist.count,
                   "requests_delivered": self.requests_delivered,
                   "requests_expired": self.requests_expired,
                   "slo_violations": self.slo_violations}
        with self._admit_lock:
            out["requests_shed"] = self.requests_shed
        return out


class MultiModelServer:
    """Several models served from ONE parameter-server process.

    Each member keeps its own serve loop, dense net and L1 caches (the
    working sets must not thrash each other); the storage levels below
    are SHARED: one VolatileDB (keys scoped ``model/table`` by the HPS),
    one PersistentDB (tables namespaced per model on disk) and one message
    bus (topics scoped ``hps.<model>.<table>``), so adding a model adds L1
    state only, and one model's online updates never touch another's
    tables at any level. Predictions equal those of per-model servers bit
    for bit: sharing storage shares bytes, not values.

    With ``cache_budget`` AND ``rebalance_interval_s`` set, the shared L1
    row budget is periodically RE-SPLIT from the observed per-model miss
    pressure (the deploy-time split is the declared hotness,
    ``api.hotness_cache_capacities``): each member's serve-loop tick calls
    the rebalancer, which at most once per interval splits the budget in
    proportion to each model's L1 misses since the last split and resizes
    the member caches (hottest rows kept). A resize rebuilds the payloads;
    the grouped K1 / K6 launch takes each batch's payload pointers as it
    finds them, so the next read needs nothing else.

    Admission control is per member: ``server[name].set_admission(...)``;
    the members' shed / expired / violation counts surface in
    :meth:`stats`.
    """

    # rebalance bookkeeping is touched from every member's serve loop, so
    # it lives behind the rebalance lock (acquired non-blocking: serving
    # never waits on it)
    _GUARDED_BY = {
        "_last_counts": "_rebalance_lock",
        "_last_rebalance": "_rebalance_lock",
        "rebalances": "_rebalance_lock",
    }

    def __init__(self, servers: Mapping[str, InferenceServer], *,
                 vdb: Optional[VolatileDB] = None,
                 pdb: Optional[PersistentDB] = None,
                 bus: Optional[MessageBus] = None,
                 cache_budget: Optional[int] = None,
                 rebalance_interval_s: Optional[float] = None,
                 rebalance_floor: int = 64):
        if not servers:
            raise ValueError("MultiModelServer needs at least one model")
        self.servers: Dict[str, InferenceServer] = dict(servers)
        self.vdb = vdb
        self.pdb = pdb
        self.bus = bus
        self.cache_budget = cache_budget
        self.rebalance_interval_s = rebalance_interval_s
        self.rebalance_floor = rebalance_floor
        self.rebalances = 0
        self._rebalance_lock = threading.Lock()
        self._last_counts: Dict[str, Tuple[int, int]] = {}
        self._last_rebalance = time.monotonic()
        if cache_budget is not None and rebalance_interval_s is not None:
            for s in self.servers.values():
                s.on_tick = self._rebalance_tick

    @property
    def models(self) -> List[str]:
        return list(self.servers)

    def __getitem__(self, model: str) -> InferenceServer:
        return self._server(model)

    def _server(self, model: str) -> InferenceServer:
        try:
            return self.servers[model]
        except KeyError:
            raise KeyError(f"unknown model {model!r}; serving "
                           f"{self.models}") from None

    def predict(self, model: str, dense: np.ndarray,
                cat: np.ndarray) -> np.ndarray:
        return self._server(model).predict(dense, cat)

    def submit(self, model: str, dense: np.ndarray,
               cat: np.ndarray) -> "queue.Queue":
        return self._server(model).submit(dense, cat)

    # -- observed-miss budget rebalance -----------------------------------------

    def _rebalance_tick(self) -> None:
        """Serve-loop hook: re-split the shared L1 budget at most once
        per ``rebalance_interval_s``. Non-blocking: if another member's
        loop is mid-rebalance, this tick just returns."""
        if not self._rebalance_lock.acquire(blocking=False):
            return
        try:  # the non-blocking acquire above holds the lock through here
            now = time.monotonic()
            # lock-ok: LOCK001 inside acquire(blocking=False)/finally-release — held, just not a with-block
            if now - self._last_rebalance < self.rebalance_interval_s:
                return
            # lock-ok: LOCK001 inside acquire(blocking=False)/finally-release — held, just not a with-block
            self._last_rebalance = now
            # lock-ok: LOCK004 inside acquire(blocking=False)/finally-release — held, just not a with-block
            self._rebalance_locked()
        finally:
            self._rebalance_lock.release()

    def rebalance_now(self) -> Dict[str, int]:
        """Force one budget re-split at once (tests / operators); returns
        the per-model capacities now in effect."""
        if self.cache_budget is None:
            raise ValueError("rebalance_now() needs the server's "
                             "cache_budget (the rows to split)")
        with self._rebalance_lock:
            self._last_rebalance = time.monotonic()
            self._rebalance_locked()
        return {name: s.hps.cache_capacity
                for name, s in self.servers.items()}

    def _rebalance_locked(self) -> None:
        """Split ``cache_budget`` in proportion to each model's L1 misses
        since the last split (+1, so an idle member keeps a foothold),
        floored so a cold member still serves, and resize the members
        whose share moved more than 10% (small drifts are not worth a
        resize's re-pull)."""
        demand: Dict[str, int] = {}
        for name, s in self.servers.items():
            hits = misses = 0
            for c in s.hps.caches.values():
                cnt = c.counters()
                hits += cnt["hits"]
                misses += cnt["misses"]
            _, pm = self._last_counts.get(name, (0, 0))
            self._last_counts[name] = (hits, misses)
            demand[name] = (misses - pm) + 1
        total = sum(demand.values())
        moved = 0
        for name, d in demand.items():
            s = self.servers[name]
            floor = max(self.rebalance_floor, s.hps.cache_shards)
            cap = max(floor, int(round(self.cache_budget * d / total)))
            cur = s.hps.cache_capacity
            if abs(cap - cur) <= max(1, int(0.1 * cur)):
                continue
            s.hps.resize_caches(cap)
            if s.wide_hps is not None:
                s.wide_hps.resize_caches(cap)
            for ehps in s.extra_hps.values():
                ehps.resize_caches(cap)
            moved += 1
        if moved:
            self.rebalances += 1

    def start(self):
        for s in self.servers.values():
            s.start()

    def stop(self):
        for s in self.servers.values():
            s.stop()

    def close(self):
        """Close every member: refuse new work, finish in-flight groups,
        reject every still-queued handle; no caller blocks forever."""
        for s in self.servers.values():
            s.close()

    def stats(self) -> Dict[str, Dict]:
        """Per-model serving picture: L1/L2/L3 + refresh + latency +
        admission (shed / expired / SLO-violation counts)."""
        out = {}
        for name, s in self.servers.items():
            c = s.counters()
            out[name] = {"hps": s.hps.stats(),
                         "cache_capacity": s.hps.cache_capacity,
                         "latency_ms": s.latency_percentiles(),
                         "updates_applied": c["updates_applied"],
                         "rows_refreshed": c["rows_refreshed"],
                         "requests_delivered": c["requests_delivered"],
                         "requests_shed": c["requests_shed"],
                         "requests_expired": c["requests_expired"],
                         "slo_violations": c["slo_violations"]}
        return out

    def rebalance_stats(self) -> Dict:
        """Budget-rebalancer picture: splits performed + current split."""
        with self._rebalance_lock:
            n = self.rebalances
        return {"rebalances": n, "cache_budget": self.cache_budget,
                "capacities": {name: s.hps.cache_capacity
                               for name, s in self.servers.items()}}
