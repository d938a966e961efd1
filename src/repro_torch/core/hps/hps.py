"""Hierarchical Parameter Server (paper §3), counterpart of
``repro/core/hps/hps.py``.

Lookup path per table: L1 device cache -> L2 volatile DB -> L3 persistent
DB, with promotion on miss at every level. Each table resolves through a
HOST stage (index probe + one coalesced miss fetch) and a DEVICE
stage (the one payload scatter + the slot block's transfer). In
``lookup`` and ``lookup_stream`` a batch's device stage ships every
table's slot block and deferred scatter in ONE pinned host-to-device
copy (``device.to_device_many``); the pooled ``[B, T, D]`` output is then
read on the device for all tables at once (one K1 launch, or one K6 for
int8 payloads). ``pipelined=True`` runs the probes on two host workers,
and ``lookup_stream`` probes query *i+1* while query *i* runs its device
stage; ``lookup_stage_sync`` is the no-overlap engine the others are
compared with (each table's arrays in plain copies of their own, then a
wait). Every plan gathers from its own payload snapshot (see
``payload_store``), so all engines give identical results.

With ``cache_shards=N`` the caches stripe their payloads on the one
device; the device stage remaps each slot block onto the stripes' flat
view on the host, so the pooled read stays one launch. With a
``cache_mesh`` of several devices (``launch.mesh.make_cache_mesh``) the
stripes are laid out across them and the pooled read is the reference's
``sharded_pooled_lookup`` of every table: one owner-mapped K5 / K6 launch
on every device for all the tables over its own stripes; the other
devices' rows meet on the first device (the HPS device), whose launch
pools each row's slots in order.

Online updates: the ``bus`` Consumer applies trainer messages to L2/L3
and marks the touched L1 rows dirty (``apply_updates``); the
hotness-scheduled refresh (``refresh_step``, driven by the serving loop,
see ``serve.server``) then re-pulls them in bounded chunks, hot rows
first.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.core.hps.embedding_cache import DeviceEmbeddingCache, LookupPlan
from repro_torch.core.hps.message_bus import Consumer, MessageBus
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.core.hps.volatile_db import VolatileDB
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

#: (table index, overflow positions, overflow rows, hotness) per table
Overflow = Tuple[int, np.ndarray, np.ndarray, int]


def _pooled_stack(payloads: Sequence[tuple], slots: Sequence[torch.Tensor],
                  combiners: Sequence[str],
                  apply_mean: bool = True, mesh=None) -> torch.Tensor:
    """The pooled gathers of all tables, ``[B, T, D]`` f32, in one device
    dispatch (as the reference's). Each payload is a ``(payload, scales)``
    snapshot; int8 stores dequantize inside the gather kernel. On a cache
    ``mesh`` each payload is the per-device stripe blocks, and each entry
    reads all the tables in one owner-mapped launch
    (``ops.mesh_pooled_read``). The mean renorm divides each mean table's
    slice in place."""
    if mesh is not None:
        out = ops.mesh_pooled_read(payloads, slots)
    else:
        out = ops.grouped_pooled_lookup(payloads, slots)
    if apply_mean:
        for ti, (s, comb) in enumerate(zip(slots, combiners)):
            if comb == "mean":
                denom = (s >= 0).sum(dim=1, keepdim=True).clamp_min(1)
                out[:, ti].div_(denom.to(out.dtype))
    return out


class HPS:

    # the L3 counters have their own lock (probe and refresh fetches
    # race), the lazy host pool is built under _pool_lock
    _GUARDED_BY = {
        "_l3_fetch_calls": "_l3_stats_lock",
        "_l3_fetch_rows": "_l3_stats_lock",
        "_host_pool": "_pool_lock",
    }

    def __init__(self, model_name: str,
                 tables: Sequence[EmbeddingTableConfig],
                 pdb: PersistentDB, *,
                 vdb: Optional[VolatileDB] = None,
                 cache_capacity: int = 4096,
                 bus: Optional[MessageBus] = None,
                 cache_shards: int = 1, cache_mesh=None,
                 refresh_chunk_rows: int = 1024,
                 payload_dtype: str = "f32",
                 device: DeviceLike = None):
        self.model_name = model_name
        self.tables = tuple(tables)
        self.pdb = pdb
        self.vdb = vdb or VolatileDB()
        if cache_mesh is not None and len(cache_mesh) > 1:
            # the stripes' partial rows meet on the mesh's first device
            device = cache_mesh[0] if device is None else device
        else:
            cache_mesh = None
        self.device = resolve_device(device)
        self.cache_mesh = cache_mesh
        self.cache_shards = cache_shards
        self.cache_capacity = cache_capacity
        self.payload_dtype = payload_dtype
        self._table_cfg: Dict[str, EmbeddingTableConfig] = {
            t.name: t for t in tables}
        self._l3_fetch_calls: Dict[str, int] = {t.name: 0 for t in tables}
        self._l3_fetch_rows: Dict[str, int] = {t.name: 0 for t in tables}
        self._l3_stats_lock = threading.Lock()
        self.caches: Dict[str, DeviceEmbeddingCache] = {}
        for t in tables:
            self.caches[t.name] = DeviceEmbeddingCache(
                min(cache_capacity, t.vocab_size), t.dim,
                fetch_fn=self._make_fetch(t.name), shards=cache_shards,
                mesh=cache_mesh, refresh_chunk_rows=refresh_chunk_rows,
                payload_dtype=payload_dtype, device=self.device)
        self.consumer = Consumer(bus, model_name) if bus else None
        self._host_pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        #: the lookahead the adaptive ``lookup_stream`` last settled on
        #: (and the deepest it reached)
        self.stream_depth = 2
        self.stream_depth_peak = 2

    # -- L2/L3 fall-through ------------------------------------------------------

    def _vdb_key(self, table: str) -> str:
        """L2 keys are scoped by model, as in the reference."""
        return f"{self.model_name}/{table}"

    def _make_fetch(self, table: str):
        dim = self._table_cfg[table].dim
        key = self._vdb_key(table)

        def fetch(ids: np.ndarray) -> np.ndarray:
            mask, rows = self.vdb.query(key, ids)
            if rows is None:        # L2 held none of the ids
                if not len(ids):
                    return np.zeros((0, dim), np.float32)
                missing = ids
            elif mask.all():
                return rows
            else:
                miss = ~mask
                missing = ids[miss]
            fetched = self.pdb.fetch(self.model_name, table, missing)
            with self._l3_stats_lock:
                self._l3_fetch_calls[table] += 1
                self._l3_fetch_rows[table] += len(missing)
            if missing is ids:
                rows = fetched
            else:
                rows[miss] = fetched
            self.vdb.insert(key, missing, fetched)  # promote
            return rows
        return fetch

    # -- query validation ---------------------------------------------------------

    def _split_query(self, cat: np.ndarray,
                     hotness: Optional[List[int]]) -> List[np.ndarray]:
        """Validate the query shape and return per-table id blocks [B, H_t]."""
        T = len(self.tables)
        if cat.ndim == 2:
            if hotness is None:
                raise ValueError(
                    "2-D cat requires hotness=[ids per table] to split "
                    f"the {cat.shape[1]} id columns over {T} tables")
            if len(hotness) != T:
                raise ValueError(
                    f"hotness has {len(hotness)} entries for {T} tables")
            if sum(hotness) != cat.shape[1]:
                raise ValueError(
                    f"sum(hotness)={sum(hotness)} != cat.shape[1]="
                    f"{cat.shape[1]}")
            return np.split(cat, np.cumsum(hotness)[:-1], axis=1)
        if cat.ndim != 3:
            raise ValueError(f"cat must be [B, T, H] or [B, sum(hotness)]; "
                             f"got shape {cat.shape}")
        if cat.shape[1] != T:
            raise ValueError(
                f"cat.shape[1]={cat.shape[1]} does not match the "
                f"{T} tables of model '{self.model_name}'")
        blocks = [cat[:, ti, :] for ti in range(T)]
        if hotness is not None:
            if len(hotness) != T:
                raise ValueError(
                    f"hotness has {len(hotness)} entries for {T} tables")
            for ti, h in enumerate(hotness):
                if h > cat.shape[2]:
                    raise ValueError(
                        f"hotness[{ti}]={h} exceeds id columns "
                        f"{cat.shape[2]}")
                if h < cat.shape[2]:  # mask columns beyond the hotness
                    blk = blocks[ti].copy()
                    blk[:, h:] = -1
                    blocks[ti] = blk
        return blocks

    def _check_dims(self) -> int:
        dims = {t.dim for t in self.tables}
        if len(dims) != 1:
            raise ValueError(
                f"stacked lookup needs equal table dims, got {sorted(dims)}")
        return dims.pop()

    # -- two-stage lookup pipeline -------------------------------------------------

    def _host_worker(self) -> ThreadPoolExecutor:
        """Host-stage workers (index probes + miss fetches). Two workers
        let table *t+1*'s probe run while table *t*'s fetch waits on the
        lower levels; same-table probes stay ordered by the cache lock."""
        with self._pool_lock:
            if self._host_pool is None:
                self._host_pool = ThreadPoolExecutor(
                    max_workers=min(2, len(self.tables)),
                    thread_name_prefix="hps-host")
            return self._host_pool

    def close(self) -> None:
        """Release the host-stage workers (idempotent)."""
        with self._pool_lock:
            pool, self._host_pool = self._host_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _probe(self, ti: int, blocks: List[np.ndarray]) -> LookupPlan:
        flat = np.ascontiguousarray(blocks[ti], np.int64).reshape(-1)
        return self.caches[self.tables[ti].name].probe(flat)

    def _device_stage(self, plans: Sequence[Tuple[int, LookupPlan]], b: int,
                      bp: int, blocks: List[np.ndarray],
                      slot_blocks: List[torch.Tensor], payloads: List[tuple],
                      overflow: List[Overflow], one_copy: bool = True
                      ) -> None:
        """The device stage of ``(table index, plan)`` pairs: one copy to
        the device carries every plan's slot block (int32, padded to
        ``bp`` rows with -1) and every still-deferred scatter (its rows,
        slots and scales), then each plan's scatter is written and its
        snapshot bound (``commit``). ``one_copy=False`` ships each array
        in a plain copy of its own instead. A striped snapshot goes out
        as its flat view, the slots remapped onto it here on the host."""
        host: List[Optional[np.ndarray]] = []
        for ti, plan in plans:
            h = blocks[ti].shape[1]
            slots = np.full((bp, h), -1, np.int32)
            slots[:b] = plan.slots.reshape(b, h)
            host.append(plan.store.flat_rows(slots))
            staged = plan.scatter if plan.payload is None else None
            host.extend(staged if staged is not None else (None,) * 3)
        dev = (devmod.to_device_many(host, self.device) if one_copy else
               [None if a is None else devmod.to_device(a, self.device)
                for a in host])
        for k, (ti, plan) in enumerate(plans):
            sb, staged = dev[4 * k], dev[4 * k + 1:4 * k + 4]
            payload = self.caches[self.tables[ti].name].commit(
                plan, None if staged[0] is None else staged)
            if self.cache_shards > 1 and self.cache_mesh is None:
                payload = ops.striped_view(payload)
            slot_blocks.append(sb)
            payloads.append(payload)
            if len(plan.ov_idx):
                overflow.append((ti, plan.ov_idx, plan.ov_rows,
                                 blocks[ti].shape[1]))

    def _finalize(self, payloads: List[tuple],
                  slot_blocks: List[torch.Tensor],
                  blocks: List[np.ndarray], overflow: List[Overflow],
                  b: int) -> torch.Tensor:
        """The pooled gathers (+ the rare host-side overflow fix)."""
        combiners = tuple("mean" if t.combiner == "mean" else "sum"
                          for t in self.tables)
        if not overflow:
            return _pooled_stack(payloads, slot_blocks, combiners,
                                 mesh=self.cache_mesh)[:b]
        # rare path: some ids exceeded L1 evictable capacity; add their
        # contribution host-side, then apply the mean denominators exactly
        out = _pooled_stack(payloads, slot_blocks, combiners,
                            apply_mean=False, mesh=self.cache_mesh)[:b]
        dim = self.tables[0].dim
        corr = np.zeros((b, len(self.tables), dim), np.float32)
        for ti, ov_idx, ov_rows, h in overflow:
            np.add.at(corr[:, ti, :], ov_idx // h, ov_rows)
        out = out + torch.from_numpy(corr).to(self.device)
        mean_mask = np.asarray([c == "mean" for c in combiners])
        if mean_mask.any():
            denom = np.stack(
                [np.maximum((blk >= 0).sum(axis=1), 1) for blk in blocks],
                axis=1).astype(np.float32)[:, :, None]
            mask_t = torch.from_numpy(mean_mask).to(self.device)
            out = torch.where(mask_t[None, :, None],
                              out / torch.from_numpy(denom).to(self.device),
                              out)
        return out

    def lookup(self, cat: np.ndarray, hotness: Optional[List[int]] = None,
               *, pipelined: bool = False) -> torch.Tensor:
        """``cat [B, T, H]`` or ``[B, sum(hotness)]`` (-1 pad) -> pooled
        ``[B, T, D]`` f32 on the HPS device, honoring each table's
        combiner. The batch pads to a power of two with -1 slots (and is
        sliced back), as in the reference."""
        cat = np.asarray(cat)
        blocks = self._split_query(cat, hotness)
        self._check_dims()
        T = len(self.tables)
        b = cat.shape[0]
        if b == 0:
            return torch.zeros((0, T, self.tables[0].dim),
                               dtype=torch.float32, device=self.device)
        bp = 1 << (b - 1).bit_length()
        slot_blocks: List[torch.Tensor] = []
        payloads: List[tuple] = []
        overflow: List[Overflow] = []
        if pipelined and T > 1:
            pool = self._host_worker()
            futs = [pool.submit(self._probe, ti, blocks) for ti in range(T)]
            plans = [f.result() for f in futs]
        else:
            plans = [self._probe(ti, blocks) for ti in range(T)]
        self._device_stage(list(enumerate(plans)), b, bp, blocks,
                           slot_blocks, payloads, overflow)
        return self._finalize(payloads, slot_blocks, blocks, overflow, b)

    def lookup_stage_sync(self, cat: np.ndarray,
                          hotness: Optional[List[int]] = None
                          ) -> torch.Tensor:
        """Fully stage-synchronous lookup: each table's arrays go to the
        device in plain copies of their own, and its scatter is waited
        for before the next host probe, the pooled read before returning;
        no overlap of any kind. The no-overlap engine the
        pipelined ones are compared with; the same result as
        :meth:`lookup`."""
        cat = np.asarray(cat)
        blocks = self._split_query(cat, hotness)
        self._check_dims()
        b = cat.shape[0]
        if b == 0:
            return torch.zeros((0, len(self.tables), self.tables[0].dim),
                               dtype=torch.float32, device=self.device)
        bp = 1 << (b - 1).bit_length()
        slot_blocks: List[torch.Tensor] = []
        payloads: List[tuple] = []
        overflow: List[Overflow] = []
        for ti in range(len(self.tables)):
            self._device_stage([(ti, self._probe(ti, blocks))], b, bp,
                               blocks, slot_blocks, payloads, overflow,
                               one_copy=False)
            devmod.synchronize(self.device)         # no overlap
        out = self._finalize(payloads, slot_blocks, blocks, overflow, b)
        devmod.synchronize(self.device)
        return out

    def _timed_probe(self, ti: int, blocks: List[np.ndarray],
                     rec: List[float]) -> LookupPlan:
        t0 = time.perf_counter()
        plan = self._probe(ti, blocks)
        rec.append(time.perf_counter() - t0)
        return plan

    def lookup_stream(self, cats: Iterable[np.ndarray],
                      hotness: Optional[List[int]] = None, *,
                      depth: Optional[int] = None, max_depth: int = 8,
                      materialize: bool = True) -> Iterator:
        """Serve a stream of queries through the two-stage pipeline,
        yielding ``[B, T, D]`` pooled outputs in order.

        Host workers probe query *i+1* (and fetch its misses) while the
        calling thread runs query *i*'s device stages. ``depth`` bounds
        the lookahead; ``None`` auto-tunes it to ``ceil(fetch/compute)+1``
        within ``[2, max_depth]`` as the reference does.
        ``materialize=False`` yields the device tensors right after each
        query's launches (the stream-fed server chains the dense net on
        them); ``True`` yields numpy arrays, synced one query behind.
        """
        self._check_dims()
        pool = self._host_worker()
        it = iter(cats)
        pending: deque = deque()
        exhausted = False
        adaptive = depth is None
        cur_depth = 2 if adaptive else max(1, depth)
        cap = max(cur_depth, max_depth)
        workers = max(1, min(2, len(self.tables)))
        ema_fetch: Optional[float] = None
        ema_compute: Optional[float] = None
        self.stream_depth = cur_depth
        self.stream_depth_peak = max(self.stream_depth_peak, cur_depth)

        def admit():
            nonlocal exhausted
            while not exhausted and len(pending) < max(1, cur_depth):
                try:
                    cat = np.asarray(next(it))
                except StopIteration:
                    exhausted = True
                    return
                blocks = self._split_query(cat, hotness)
                rec: List[float] = []
                futs = [pool.submit(self._timed_probe, ti, blocks, rec)
                        for ti in range(len(self.tables))]
                pending.append((cat.shape[0], blocks, futs, rec))

        in_flight: List[torch.Tensor] = []
        try:
            admit()
            while pending:
                b, blocks, futs, rec = pending.popleft()
                plans = [f.result() for f in futs]
                t0 = time.perf_counter()
                bp = 1 << (b - 1).bit_length()
                slot_blocks, payloads, overflow = [], [], []
                self._device_stage(list(enumerate(plans)), b, bp, blocks,
                                   slot_blocks, payloads, overflow)
                out = self._finalize(payloads, slot_blocks, blocks,
                                     overflow, b)
                admit()                     # next query probes first ...
                if not materialize:         # ... caller owns the sync
                    yield out
                else:
                    in_flight.append(out)
                    if len(in_flight) > 1:  # ... then sync, one behind
                        yield in_flight.pop(0).cpu().numpy()
                if adaptive:
                    compute = max(time.perf_counter() - t0, 1e-6)
                    fetch = sum(rec) / workers
                    ema_fetch = fetch if ema_fetch is None \
                        else 0.5 * ema_fetch + 0.5 * fetch
                    ema_compute = compute if ema_compute is None \
                        else 0.5 * ema_compute + 0.5 * compute
                    cur_depth = int(min(cap, max(
                        2, math.ceil(ema_fetch / ema_compute) + 1)))
                    self.stream_depth = cur_depth
                    self.stream_depth_peak = max(self.stream_depth_peak,
                                                 cur_depth)
            for out in in_flight:
                yield out.cpu().numpy()
        finally:
            for _, _, futs, _ in pending:   # abandoned mid-stream
                for f in futs:
                    f.cancel()

    # -- online updates -------------------------------------------------------------

    def apply_updates(self) -> int:
        """Poll the message bus into VDB+PDB and schedule the touched L1
        rows for refresh (the hotness scheduler drains them). As in the
        reference, every table of the model goes to L2/L3, and only this
        HPS's own tables are marked dirty; returns #messages applied."""
        if self.consumer is None:
            return 0

        def apply(table, ids, rows):
            self.pdb.upsert(self.model_name, table, ids, rows)
            self.vdb.insert(self._vdb_key(table), ids, rows)
            cache = self.caches.get(table)
            if cache is not None:
                cache.mark_dirty(ids)

        return self.consumer.poll(apply)

    def schedule_refresh(self) -> int:
        """Mark every resident L1 row stale (the poll-cycle fallback when
        no update stream identifies the changed rows)."""
        return sum(c.mark_all_dirty() for c in self.caches.values())

    def refresh_step(self, budget: Optional[int] = None) -> int:
        """Drain one bounded, hotness-ordered chunk of the refresh backlog
        per table; the serving loop calls this between batches."""
        return sum(c.refresh_chunk(budget) for c in self.caches.values())

    def refresh_backlog(self) -> int:
        return sum(c.refresh_backlog() for c in self.caches.values())

    def refresh_caches(self) -> int:
        """Full re-pull of every resident row (offline convenience)."""
        return sum(c.refresh_once() for c in self.caches.values())

    def resize_caches(self, capacity: int) -> int:
        """Rebuild every table's L1 at ``min(capacity, vocab)`` rows,
        keeping the hottest residents; returns the rows kept across
        tables."""
        kept = 0
        for t in self.tables:
            kept += self.caches[t.name].resize(min(capacity, t.vocab_size))
        self.cache_capacity = capacity
        return kept

    def start_refresh(self, interval_s: float):
        for c in self.caches.values():
            c.start_refresh(interval_s)

    def stop_refresh(self):
        for c in self.caches.values():
            c.stop_refresh()

    # -- metrics ---------------------------------------------------------------------

    def stats(self) -> Dict:
        with self._l3_stats_lock:
            l3 = {"calls": dict(self._l3_fetch_calls),
                  "rows": dict(self._l3_fetch_rows)}
        l2 = self.vdb.stats()
        l1 = {k: c.counters() for k, c in self.caches.items()}
        return {
            "l1_hit_rate": {
                k: (c["hits"] / (c["hits"] + c["misses"])
                    if c["hits"] + c["misses"] else 0.0)
                for k, c in l1.items()},
            "l2_hits": l2["hits"],
            "l2_misses": l2["misses"],
            "l2": l2,
            "l3_fetches": l3,
            "refresh": {
                "rows_refreshed": sum(c["rows_refreshed"]
                                      for c in l1.values()),
                "chunks": sum(c["refresh_chunks"] for c in l1.values()),
                "backlog": self.refresh_backlog(),
            },
            "stream": {"depth": self.stream_depth,
                       "depth_peak": self.stream_depth_peak},
        }
