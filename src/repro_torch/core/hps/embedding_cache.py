"""GPU embedding cache (HPS level 1), counterpart of
``repro/core/hps/embedding_cache.py``.

A device-resident payload (``ShardedPayloadStore``) plus a host-side
index. The index is an exact id -> slot hash map (``id_index.IdIndex``):
a probe searches and updates it in time that grows with the probe's ids,
where the reference searches a sorted id array and re-sorts it on every
probe that misses. A probe is two passes of the host library (``_host``):
the first makes ``np.unique``'s dedup, the search, the counters and the
hits' LFU update, the second places the misses (the index, ``_id_of``,
``_freq``, ``_dirty``) and gives each id its slot. What decides a slot
between them (coalesced miss fetch, batch-aware LFU eviction with its
``argpartition``, the hottest misses kept on overflow by a stable
``argsort``) is the reference's numpy code unchanged, and the passes keep
its orders and its double adds, so both packages make the same slot
decisions on the same query stream, and ``_sorted_ids`` /
``_sorted_slots`` read back the reference's sorted index.

The query splits into a HOST stage (``probe``: index probe + coalesced
miss fetch; the payload scatter is deferred) and a DEVICE stage
(``commit``: the one payload scatter + snapshot binding), so a pipelined
caller overlaps table *t+1*'s probe with table *t*'s scatter, and query
*i+1*'s probes with query *i*'s device stage. Deferred scatters queue in
probe order, and a probe leaves them queued: the host index may run
ahead of the payload, which is read only through a plan's snapshot or
after a flush. A commit (or any call that reads the payload) writes the
queued scatters in order up to its plan, binding each plan's snapshot
right after its own scatter, so a snapshot is taken before any later
query's scatter (copy-on-write) overwrites the slots it reads.

Refresh is hotness-scheduled, as in the reference: online updates (or a
poll cycle) mark resident rows dirty; ``refresh_chunk`` claims up to a
per-cycle budget of the dirtiest-and-hottest rows (the LFU counters order
the backlog), re-pulls them from the lower levels with the lock released,
and scatters only rows whose id->slot binding survived, so refresh
interleaves with serving instead of stopping the world. ``resize``
rebuilds the cache at another capacity, keeping the hottest rows.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core.hps import _host
from repro_torch.core.hps.id_index import IdIndex
from repro_torch.core.hps.payload_store import ShardedPayloadStore
from repro_torch.device import DeviceLike


class LookupPlan:
    """Host-stage output: resolved slots + out-of-band overflow rows,
    with the payload snapshot bound at device-stage time (``commit``).
    ``store`` is the payload store the slots index (its stripe layout
    maps them to flat rows); ``scatter`` is the plan's deferred scatter
    as ``ShardedPayloadStore.prepare`` gives it (None when the probe
    inserted nothing), which a caller may ship to the device with other
    data and hand back to ``commit``."""

    __slots__ = ("slots", "ov_idx", "ov_rows", "payload", "store",
                 "scatter")

    def __init__(self, slots: np.ndarray, ov_idx: np.ndarray,
                 ov_rows: np.ndarray, payload, store=None, scatter=None):
        self.slots = slots
        self.ov_idx = ov_idx
        self.ov_rows = ov_rows
        self.payload = payload
        self.store = store
        self.scatter = scatter


class DeviceEmbeddingCache:

    # every listed attribute is touched only under self._lock; fetch_fn
    # is the injected L2/L3 fall-through, which takes the VDB's and its
    # namespaces' locks, the PDB lock and the HPS L3 counters' lock
    # (declared for the lock-order pass)
    _GUARDED_BY = {
        "_id_of": "_lock", "_freq": "_lock", "_next_free": "_lock",
        "_index": "_lock", "_pending": "_lock",
        "_dirty": "_lock", "hits": "_lock", "misses": "_lock",
        "rows_refreshed": "_lock", "refresh_chunks": "_lock",
        "_work": "_lock", "_info": "_lock",
    }
    _LOCKS_OF = {
        "fetch_fn": ("VolatileDB._lock", "_Namespace._lock",
                     "PersistentDB._lock", "HPS._l3_stats_lock"),
    }

    def __init__(self, capacity: int, dim: int, *,
                 fetch_fn: Callable[[np.ndarray], np.ndarray],
                 decay: float = 0.99, shards: int = 1, mesh=None,
                 refresh_chunk_rows: int = 1024,
                 payload_dtype: str = "f32", device: DeviceLike = None):
        """``fetch_fn(missing_ids) -> rows`` pulls from VDB/PDB.
        ``shards`` stripes the payload (``payload_store``);
        ``refresh_chunk_rows`` is the default refresh budget a chunk."""
        self.capacity = capacity
        self.dim = dim
        self.fetch_fn = fetch_fn
        self.decay = decay
        self.payload_dtype = payload_dtype
        self._store = ShardedPayloadStore(capacity, dim, shards=shards,
                                          mesh=mesh,
                                          payload_dtype=payload_dtype,
                                          device=device)
        self.device = self._store.device
        self._id_of = np.full(capacity, -1, np.int64)
        self._freq = np.zeros(capacity, np.float64)
        self._next_free = 0
        self._index = IdIndex()
        #: the probe passes' work rows (``_host.W_*``) and counts
        self._work = np.empty((_host.L1_ROWS, 0), np.int64)
        self._info = _host.info_buffer()
        self.hits = 0
        self.misses = 0
        #: plans whose snapshot is not bound yet, in probe order
        self._pending: Deque[LookupPlan] = deque()
        # refresh scheduler state
        self._dirty = np.zeros(capacity, bool)
        self.refresh_chunk_rows = refresh_chunk_rows
        self.rows_refreshed = 0
        self.refresh_chunks = 0
        self._lock = threading.RLock()
        self._refresh_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def shards(self) -> int:
        return self._store.shards

    @property
    def payload(self):
        """Current ``(payload, scales)`` snapshot (pending scatter
        flushed)."""
        with self._lock:
            self._flush_pending_locked()
            return self._store.snapshot()

    # -- host index --------------------------------------------------------------

    def _find_locked(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized id -> slot (-1 if not resident, a pad included)."""
        return self._index.find(ids)

    def _rebuild_index_locked(self) -> None:
        occ = self._id_of[:self._next_free]
        self._index = IdIndex(occ, np.arange(len(occ), dtype=np.int64))

    @property
    def _sorted_ids(self) -> np.ndarray:
        """The resident ids, sorted: the reference's index array."""
        with self._lock:
            return self._index.sorted_view()[0]

    @property
    def _sorted_slots(self) -> np.ndarray:
        """The slot of each of :attr:`_sorted_ids`."""
        with self._lock:
            return self._index.sorted_view()[1]

    def resident_ids(self) -> np.ndarray:
        """Ids currently resident in the cache (sorted)."""
        return self._sorted_ids

    # -- two-stage query ---------------------------------------------------------

    def probe(self, ids: np.ndarray) -> LookupPlan:
        """HOST stage: resolve ``ids [n]`` (-1 = pad) to payload slots,
        fetching + index-inserting misses; the payload scatter is deferred
        to ``commit``. A plan binds its snapshot at once when it inserted
        nothing and no scatter is queued; else it queues, and binds when
        the queue flushes up to it (its own ``commit``, a later plan's, or
        a call that reads the payload, whichever is first)."""
        with self._lock:
            slots, ov_idx, ov_rows, scatter = self._probe_locked(
                np.asarray(ids, np.int64))
            plan = LookupPlan(slots, ov_idx, ov_rows, None, self._store,
                              scatter)
            if scatter is None and not self._pending:
                plan.payload = self._store.snapshot()
            else:
                self._pending.append(plan)
            return plan

    def commit(self, plan: LookupPlan, staged=None):
        """DEVICE stage: write the queued scatters up to the plan's own
        and return its snapshot. Gather from IT, not from
        ``self.payload``. ``staged`` is ``plan.scatter`` already on the
        device (``(idx, rows, scales)`` tensors), written instead of
        copying it again; unused if another call flushed it first."""
        if plan.payload is None:
            with self._lock:
                self._flush_pending_locked(plan, staged)
        return plan.payload

    def acquire_slots(self, ids: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, tuple]:
        """Both stages back-to-back: ``(slots, ov_idx, ov_rows, payload)``."""
        plan = self.probe(ids)
        return plan.slots, plan.ov_idx, plan.ov_rows, self.commit(plan)

    def _flush_pending_locked(self, upto: Optional[LookupPlan] = None,
                              staged=None) -> None:
        """Write the queued scatters in probe order, each plan's snapshot
        bound right after its own, up to ``upto`` (all when None);
        ``upto``'s scatter is ``staged`` when given."""
        while self._pending:
            plan = self._pending.popleft()
            if plan.scatter is not None:
                self._store.write(*(
                    staged if plan is upto and staged is not None
                    else devmod.to_device_many(plan.scatter, self.device)))
            plan.payload = self._store.snapshot()
            if plan is upto:
                return

    def _work_locked(self, n: int) -> np.ndarray:
        """The probe passes' work rows, at least ``n`` wide."""
        if self._work.shape[1] < n:
            self._work = np.empty(
                (_host.L1_ROWS, max(n, 2 * self._work.shape[1])), np.int64)
        return self._work

    def _probe_locked(self, ids: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 Optional[tuple]]:
        """``(slots, overflow positions, overflow rows, the deferred
        scatter as ShardedPayloadStore.prepare gives it or None)``."""
        n = len(ids)
        ov_idx, ov_rows = (np.empty(0, np.int64),
                           np.empty((0, self.dim), np.float32))
        if n == 0:
            return np.empty(0, np.int64), ov_idx, ov_rows, None
        work = self._work_locked(n)
        work[_host.W_IDS, :n] = ids
        # pass 1: uniq = np.unique(max(ids, -1)) (every pad one -1 entry,
        # first), its counts and inverse, the search, the hits' counters
        _host.check("hps_l1_pass1", _host.call(
            "hps_l1_pass1", self._index.handle, n, _host.ptr(self._freq),
            _host.ptr(work), work.shape[1], self._info))
        n_uniq, n_hit, n_pad, k, n_hit_u = self._info[:5]
        self.hits += n_hit
        self.misses += n - n_hit - n_pad
        if k == 0:
            return work[_host.W_OUT, :n].copy(), ov_idx, ov_rows, None

        miss_ids = work[_host.W_MISS_IDS, :k].copy()    # in uniq's order
        # lock-ok: LOCK002 probe fetch under the lock preserves same-table ordering; the pipelined engine keeps it off the hot thread
        rows = np.asarray(self.fetch_fn(miss_ids), np.float32)
        n_occ = self._next_free
        free = min(k, self.capacity - n_occ)
        dest = np.arange(n_occ, n_occ + free, dtype=np.int64)
        if k > free:
            victims = self._evict_locked(
                k - free, work[_host.W_HIT_SLOTS, :n_hit_u])
            if len(victims):
                dest = _host.i64(np.concatenate([dest, victims]))
        ins = len(dest)
        sel = ovf = None
        if ins < k:  # cache the hottest misses, overflow the rest
            order = np.argsort(-work[_host.W_MISS_COUNTS, :k], kind="stable")
            sel, ovf = _host.i64(order[:ins]), order[ins:]
        self._next_free = n_occ + free
        scatter = None
        if ins:
            # pass 2: the index, _id_of, _freq, _dirty (fresh from the
            # lower levels) at dest, and each id's slot
            rc = _host.call("hps_l1_pass2", self._index.handle, n,
                _host.ptr(self._id_of), _host.ptr(self._freq),
                _host.ptr(self._dirty), _host.ptr(work), work.shape[1],
                None if sel is None else _host.ptr(sel),
                _host.ptr(dest), ins, free)
            if rc > 0:
                raise KeyError(f"evicted slot {int(dest[free + rc - 1])} "
                               "held no indexed id")
            _host.check("hps_l1_pass2", rc)
            # the ONE device scatter, deferred to commit()
            scatter = self._store.prepare(dest,
                                          rows if sel is None else rows[sel])
        if ovf is not None:
            ov_uniq = np.full(n_uniq, -1, np.int64)
            ov_uniq[work[_host.W_MISS_POS, :k][ovf]] = np.arange(len(ovf))
            per_elem = ov_uniq[work[_host.W_INV, :n]]
            ov_idx = np.nonzero(per_elem >= 0)[0].astype(np.int64)
            ov_rows = rows[ovf][per_elem[ov_idx]]
        return work[_host.W_OUT, :n].copy(), ov_idx, ov_rows, scatter

    def _evict_locked(self, want: int, hit_slots: np.ndarray) -> np.ndarray:
        """Batch-aware LFU eviction of up to ``want`` residents: age every
        counter once a batch, protect the slots this query reads (each
        hit slot once), and take the coldest in one ``argpartition``."""
        n_occ = self._next_free
        self._freq[:n_occ] *= self.decay
        cost = self._freq[:n_occ].copy()
        cost[hit_slots] = np.inf
        take = min(want, n_occ - len(hit_slots))
        if take <= 0:
            return hit_slots[:0]
        return np.argpartition(cost, take - 1)[:take]

    def _scatter_locked(self, slots: np.ndarray, rows: np.ndarray) -> None:
        self._store.scatter(slots, rows)

    def query(self, ids: np.ndarray) -> torch.Tensor:
        """Batched lookup ``[n] -> [n, D]`` f32 on the cache's device with
        dynamic insertion: one host index pass, at most one fetch and one
        scatter, and one gather launch (K5, or K6 when compressed) over
        the power-of-two padded slot block."""
        slots, ov_idx, ov_rows, payload = self.acquire_slots(ids)
        n = len(slots)
        if n == 0:
            return torch.zeros((0, self.dim), dtype=torch.float32,
                               device=self.device)
        bucket = 1 << (n - 1).bit_length()
        spad = np.pad(slots, (0, bucket - n), constant_values=-1)
        out = self._store.gather(payload, spad.astype(np.int32))[:n]
        if len(ov_idx):  # rare: batch exceeded evictable capacity
            out[torch.from_numpy(ov_idx).to(self.device)] = \
                torch.from_numpy(ov_rows).to(self.device)
        return out

    # -- hotness-scheduled refresh (propagation of online updates) ---------------

    def mark_dirty(self, ids: np.ndarray) -> int:
        """Schedule resident rows among ``ids`` for refresh (the lower
        levels changed under them). Returns how many were resident."""
        ids = np.unique(np.asarray(ids, np.int64))
        with self._lock:
            slots = self._find_locked(ids)
            slots = slots[slots >= 0]
            self._dirty[slots] = True
            return len(slots)

    def mark_all_dirty(self) -> int:
        """Schedule every resident row (the poll-cycle fallback when no
        update stream says which rows changed)."""
        with self._lock:
            n = self._next_free
            self._dirty[:n] = True
            return n

    def refresh_backlog(self) -> int:
        """Rows currently scheduled for refresh."""
        with self._lock:
            return int(self._dirty[:self._next_free].sum())

    def refresh_chunk(self, budget: Optional[int] = None) -> int:
        """Refresh up to ``budget`` scheduled rows, hottest first.

        Claims the selected rows (clears their dirty bit) under the lock,
        re-pulls them from the lower levels with the lock RELEASED (the
        slow IO never blocks serving), then scatters only rows whose
        id->slot binding survived the interim; an update that lands
        mid-fetch re-marks the row, so the next chunk repairs it. Returns
        the number of rows refreshed on the device."""
        budget = self.refresh_chunk_rows if budget is None else budget
        if budget <= 0:
            return 0
        with self._lock:
            self._flush_pending_locked()
            occ = self._next_free
            cand = np.nonzero(self._dirty[:occ])[0]
            if len(cand) == 0:
                return 0
            if len(cand) > budget:
                hot = np.argpartition(-self._freq[cand], budget - 1)
                cand = cand[hot[:budget]]
            slots = np.sort(cand).astype(np.int64)
            self._dirty[slots] = False            # claimed
            ids = self._id_of[slots].copy()
        rows = np.asarray(self.fetch_fn(ids), np.float32)   # slow IO
        with self._lock:
            keep = self._find_locked(ids) == slots  # binding may have moved
            kept = int(keep.sum())
            if kept:
                self._scatter_locked(slots[keep], rows[keep])
            self.rows_refreshed += kept
            self.refresh_chunks += 1
            return kept

    def refresh_once(self, chunk: Optional[int] = None) -> int:
        """Re-pull every resident row from the lower levels, in
        hotness-ordered bounded chunks (the full-repull convenience)."""
        marked = self.mark_all_dirty()
        if marked == 0:
            return 0
        chunk = chunk or self.refresh_chunk_rows
        total = 0
        # enough rounds to drain what was just marked; rows re-marked
        # concurrently are the next cycle's work
        for _ in range(-(-marked // chunk) + 1):
            if self.refresh_backlog() == 0:
                break
            total += self.refresh_chunk(chunk)
        return total

    # -- capacity rebalance ------------------------------------------------------

    def resize(self, new_capacity: int) -> int:
        """Rebuild the cache at ``new_capacity``, keeping the hottest
        resident rows (the LFU counters order the survivors); returns how
        many were kept. A rare control-plane operation. The survivors are
        re-pulled from the lower levels, so compressed payloads requantize
        from full-precision rows, never from their own rounded ones."""
        if new_capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {new_capacity}")
        if self._store.shards > new_capacity:
            raise ValueError(
                f"new_capacity={new_capacity} is below the store's "
                f"shard count {self._store.shards}")
        with self._lock:
            if new_capacity == self.capacity:
                return self._next_free
            self._flush_pending_locked()
            n_occ = self._next_free
            keep = min(n_occ, new_capacity)
            ids = freqs = rows = None
            if keep:
                hot = np.argsort(-self._freq[:n_occ],
                                 kind="stable")[:keep].astype(np.int64)
                ids = self._id_of[hot].copy()
                freqs = self._freq[hot].copy()
                # lock-ok: LOCK002 resize is a rare control-plane op; re-pulling survivors under the lock keeps index and payload atomic
                rows = np.asarray(self.fetch_fn(ids), np.float32)
            self._store = ShardedPayloadStore(
                new_capacity, self.dim, shards=self._store.shards,
                mesh=self._store.mesh, payload_dtype=self.payload_dtype,
                device=self.device)
            self.capacity = new_capacity
            self._id_of = np.full(new_capacity, -1, np.int64)
            self._freq = np.zeros(new_capacity, np.float64)
            self._dirty = np.zeros(new_capacity, bool)
            self._next_free = keep
            if keep:
                dest = np.arange(keep, dtype=np.int64)
                self._id_of[dest] = ids
                self._freq[dest] = freqs
                self._scatter_locked(dest, rows)
            self._rebuild_index_locked()
            return keep

    def start_refresh(self, interval_s: float):
        """Run :meth:`refresh_once` every ``interval_s`` seconds on a
        thread of its own, until :meth:`stop_refresh`."""
        def loop():
            while not self._stop.wait(interval_s):
                self.refresh_once()
        self._refresh_thread = threading.Thread(target=loop, daemon=True)
        self._refresh_thread.start()

    def stop_refresh(self):
        self._stop.set()
        if self._refresh_thread:
            self._refresh_thread.join()
            self._refresh_thread = None
        self._stop.clear()

    def counters(self) -> dict:
        """Lock-consistent snapshot of the serving counters."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "rows_refreshed": self.rows_refreshed,
                    "refresh_chunks": self.refresh_chunks}

    @property
    def hit_rate(self) -> float:
        with self._lock:
            hits, misses = self.hits, self.misses
        n = hits + misses
        return hits / n if n else 0.0

