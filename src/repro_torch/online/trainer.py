"""ETC-staged training — the Embedding Training Cache as a first-class
training backend behind the graph API (HugeCTR's ``wdl_etc`` low-level
workflow); counterpart of ``repro/online/trainer.py``.

A run is split into ``ETCParams.passes`` keyset-staged passes. For each
pass the trainer (1) extracts the pass's keyset by replaying the
stateless reader and presents it to the cache up front (hottest ids win
when the keyset exceeds capacity), (2) trains with the dense+sparse step
over the cache tensors — the device never holds more than ``cache_rows``
embedding rows per table — and (3) at the pass boundary flushes the cache
through the parameter server (the durability point; ``ps="cached"``
fsyncs) and, when a publisher is attached, ships the pass's rows as ONE
versioned online update to the live serving side.

The step is plain torch: autograd through :func:`cached_lookup` (K1
forward, K3 backward over the ``[T*C, D]`` cache) and the model's dense
net (DLRM's K2 / K4), the dense gradients clipped by their global norm,
the dense optimizer, and the row-wise AdaGrad on the cache and its
accumulators. The cache's in-place staging scatters run in ``prepare``,
after the previous step's backward has released its graph.

Initial weights mirror the port's ``Trainer.init_state`` (same seed), so
an ETC run whose cache covers every vocab matches the in-memory ``fit()``
to float tolerance.

Concurrency: the trainer (and its ETC/PS) is confined to the training
thread. The only shared object is the :class:`UpdatePublisher`, which
carries its own lock contract — the live serving stack sees updates by
value over the message bus, never these tensors.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ETCParams
from repro_torch.core.etc.cache import EmbeddingTrainingCache, cached_lookup
from repro_torch.core.etc.parameter_server import CachedPS, StagedPS
from repro_torch.device import to_device
from repro_torch.models.recsys import layers
from repro_torch.models.recsys.dense_graph import GraphError
from repro_torch.models.recsys.model import (import_logical_tables,
                                             logical_tables)
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.train.train_step import (build_optimizers, split_params,
                                          value_and_grad)
from repro_torch.train.trainer import put_batch

_CHUNK = 1 << 16       # rows per PS pull/push when moving whole tables


class OnlineTrainer:

    def __init__(self, model, etc_cfg: ETCParams, *, ps=None,
                 publisher=None, seed: Optional[int] = None):
        if model._model is None:
            model.compile()
        rmodel = model._model
        if rmodel.wide is not None or rmodel.extra:
            raise GraphError(
                "ETC-staged training supports single-collection models "
                "only (no wide branch, no extra embedding groups yet) — "
                "drop Solver.etc or simplify the graph")
        self.model = model
        self.cfg = etc_cfg
        self.tcfg = model._tcfg
        self.tables = model.cfg.tables
        self.device = rmodel.device
        self.publisher = publisher
        self.seed = model.solver.seed if seed is None else seed
        self.ps = ps if ps is not None else self._build_ps()
        self.etc = EmbeddingTrainingCache(self.tables, etc_cfg.cache_rows,
                                          self.ps, device=self.device)
        # start from the weights the in-memory path would use: params
        # already held (load()/previous fit()), else a fresh init with
        # the run seed, as Trainer.init_state draws it
        if model._params is None:
            model._params = rmodel.init(
                torch.Generator().manual_seed(self.seed))
        sparse_p, dense_p = split_params(model._params)
        self._emb_template = sparse_p["embedding"]
        self._dense = dense_p
        self._seed_ps(rmodel.embedding, self._emb_template)
        self._step_fn, self._dense_opt = self._build_step()
        self._dstate = self._dense_opt.init(dense_p)
        self._cache_params = self.etc.init_params()
        self.pass_log: List[Dict] = []
        self.flush_s = 0.0

    def _build_ps(self):
        if self.cfg.ps == "cached":
            return CachedPS(self.tables, self.cfg.ps_root, seed=self.seed)
        return StagedPS(self.tables, seed=self.seed,
                        shards=self.cfg.ps_shards)

    def _seed_ps(self, collection, emb_params) -> None:
        """Write the model's initial (or loaded) embedding weights into
        the PS, zeroing the optimizer accumulator — incremental passes
        then continue FROM the deployed model, not from a fresh init."""
        full = logical_tables(collection, emb_params)
        for t in self.tables:
            rows = np.asarray(full[t.name], np.float32)
            for lo in range(0, rows.shape[0], _CHUNK):
                hi = min(rows.shape[0], lo + _CHUNK)
                ids = np.arange(lo, hi, dtype=np.int64)
                self.ps.push(t.name, ids, rows[lo:hi])
                self.ps.push_state(t.name, ids,
                                   np.zeros(hi - lo, np.float32))

    # -- the device step ---------------------------------------------------------

    def _build_step(self):
        rmodel = self.model._model
        tcfg = self.tcfg
        dense_opt, sparse_opt = build_optimizers(tcfg)

        def loss_fn(p, dense_x, label, remapped):
            emb = cached_lookup(p["cache"], remapped,
                                use_kernels=rmodel.use_kernels)
            logits = rmodel.apply_dense(p["dense"], dense_x, emb)
            return layers.bce_with_logits(logits, label)

        def step(dense_p, dstate, cache_p, dense_x, label, remapped):
            loss, grads = value_and_grad(
                loss_fn, {"dense": dense_p,
                          "cache": {"cache": cache_p["cache"]}},
                dense_x, label, remapped)
            with torch.no_grad():
                # same update math as train_step._apply_updates: global-
                # norm clip over the DENSE grads only, row-wise AdaGrad on
                # the embedding rows (here: the [T*C, D] view of the cache)
                gd, _ = clip_by_global_norm(grads["dense"], tcfg.grad_clip)
                new_dense, new_dstate = dense_opt.update(gd, dstate,
                                                         dense_p)
                t, c, d = cache_p["cache"].shape
                flat, sstate = sparse_opt.update(
                    {"x": grads["cache"]["cache"].reshape(t * c, d)},
                    {"acc": {"x": cache_p["acc"].reshape(t * c)}},
                    {"x": cache_p["cache"].reshape(t * c, d)})
            new_cache = {"cache": flat["x"].reshape(t, c, d),
                         "acc": sstate["acc"]["x"].reshape(t, c)}
            return new_dense, new_dstate, new_cache, loss

        return step, dense_opt

    # -- keyset-staged passes ------------------------------------------------------

    def _stage_keyset(self, data_fn: Callable[[int], Dict],
                      step_range) -> None:
        """Present the pass's keyset to the cache before training on it
        (HugeCTR presents each pass's keyset file the same way). The
        stateless reader is replayed to collect ids; when a table's
        keyset exceeds capacity the hottest ids win and mid-pass staging
        handles the tail."""
        per_table: List[List[np.ndarray]] = [[] for _ in self.tables]
        for s in step_range:
            cat = np.asarray(data_fn(s)["cat"])
            for ti in range(len(self.tables)):
                ids = cat[:, ti, :].ravel()
                per_table[ti].append(ids[ids >= 0])
        staged = []
        for ti in range(len(self.tables)):
            ids = np.concatenate(per_table[ti]) if per_table[ti] \
                else np.empty(0, np.int64)
            uniq, counts = np.unique(ids, return_counts=True)
            cap = min(self.etc.capacity, self.tables[ti].vocab_size)
            if uniq.size > cap:
                uniq = uniq[np.argsort(counts)[::-1][:cap]]
            staged.append(np.sort(uniq).astype(np.int64))
        width = max((s.size for s in staged), default=0)
        if width == 0:
            return
        cat = np.full((1, len(self.tables), width), -1, np.int64)
        for ti, s in enumerate(staged):
            cat[0, ti, :s.size] = s
        self._cache_params, _ = self.etc.prepare(self._cache_params, cat)

    def end_pass(self) -> Optional[int]:
        """Pass boundary: flush the cache through the PS (durability
        point) and publish the pass's FULL touched keyset as one
        versioned update — pulled from the PS after the flush, so rows
        evicted mid-pass carry their trained values too (the resident
        set alone under-reports the pass). ``flush_s`` keeps the host
        seconds of the flush (the cached tier's ``fsync`` included)."""
        t0 = time.perf_counter()
        self.etc.flush(self._cache_params)
        if hasattr(self.ps, "flush"):
            self.ps.flush()
        self.flush_s = time.perf_counter() - t0
        if self.publisher is None:
            return None
        updates = {}
        for ti, t in enumerate(self.etc.tables):
            ids = self.etc.drain_touched(ti)
            if ids.size:
                updates[t.name] = (ids, self.ps.pull(t.name, ids))
        return self.publisher.publish(updates)

    # -- train ------------------------------------------------------------------

    def fit(self, data_fn: Callable[[int], Dict], steps: int, *,
            log_every: int = 0) -> List[Dict]:
        """``steps`` steps in ``ETCParams.passes`` passes. Each history
        entry carries, beside the reference's ``step``, ``loss`` and
        ``time`` (the wall clock), the host seconds of the step's
        ``prepare`` (``prepare_s``) and of the step itself up to its
        loss's read (``step_s``); each ``pass_log`` entry its flush's
        (``flush_s``)."""
        bounds = np.linspace(0, steps, self.cfg.passes + 1).astype(int)
        history: List[Dict] = []
        for p in range(self.cfg.passes):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            if hi <= lo:
                continue
            self._stage_keyset(data_fn, range(lo, hi))
            for s in range(lo, hi):
                batch = data_fn(s)
                t0 = time.perf_counter()
                self._cache_params, remapped = self.etc.prepare(
                    self._cache_params, np.asarray(batch["cat"]))
                t1 = time.perf_counter()
                dev = put_batch({"dense": batch["dense"],
                                 "label": batch["label"]}, self.device)
                (self._dense, self._dstate, self._cache_params,
                 loss) = self._step_fn(
                    self._dense, self._dstate, self._cache_params,
                    dev["dense"], dev["label"],
                    to_device(remapped.astype(np.int32), self.device))
                loss = float(loss)
                history.append({"step": s, "loss": loss,
                                "time": time.time(), "prepare_s": t1 - t0,
                                "step_s": time.perf_counter() - t1})
                if log_every and (s + 1) % log_every == 0:
                    print(f"[etc pass {p + 1}/{self.cfg.passes}] step "
                          f"{s + 1}/{steps} loss {loss:.4f}")
            version = self.end_pass()
            self.pass_log.append({"pass": p, "steps": (lo, hi),
                                  "version": version,
                                  "flush_s": self.flush_s})
        return history

    # -- export back into the graph-API world ------------------------------------

    def export_params(self) -> Dict:
        """Full param tree (dense + embedding) with the trained PS
        contents imported back into the collection layout — the result
        feeds ``predict()``/``save()``/``deploy()`` with no knowledge of
        the ETC. Call after ``fit()`` (which ends on a flush)."""
        tables = {}
        for t in self.tables:
            rows = np.empty((t.vocab_size, t.dim), np.float32)
            for lo in range(0, t.vocab_size, _CHUNK):
                hi = min(t.vocab_size, lo + _CHUNK)
                rows[lo:hi] = self.ps.pull(
                    t.name, np.arange(lo, hi, dtype=np.int64))
            tables[t.name] = rows
        emb = import_logical_tables(self.model._model.embedding,
                                    self._emb_template, tables)
        params = dict(self._dense)
        params["embedding"] = emb
        return params
