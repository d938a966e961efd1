"""GPU embedding cache (HPS level 1), counterpart of
``repro/core/hps/embedding_cache.py``.

A device-resident payload (``ShardedPayloadStore``) plus a host-side
index. The host logic (sorted-array index, one ``searchsorted`` per
query, coalesced miss fetch, batch-aware LFU eviction, overflow) is the
reference's numpy code unchanged, so both packages make the same slot
decisions on the same query stream.

The query splits into a HOST stage (``probe``: index probe + coalesced
miss fetch; the payload scatter is deferred) and a DEVICE stage
(``commit``: the one payload scatter + snapshot binding), so a pipelined
caller overlaps table *t+1*'s probe with table *t*'s scatter. Whoever
takes the cache lock next flushes a deferred scatter, so the index and
the payload agree whenever the lock is held, and every plan's snapshot
binds before a later query can evict the slots it reads.

Online-update refresh and capacity resize come with the refresh slice
(ROADMAP item "The rest of the serving engine").
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hps.payload_store import ShardedPayloadStore
from repro_torch.device import DeviceLike


class LookupPlan:
    """Host-stage output: resolved slots + out-of-band overflow rows,
    with the payload snapshot bound at device-stage time (``commit``)."""

    __slots__ = ("slots", "ov_idx", "ov_rows", "payload")

    def __init__(self, slots: np.ndarray, ov_idx: np.ndarray,
                 ov_rows: np.ndarray, payload):
        self.slots = slots
        self.ov_idx = ov_idx
        self.ov_rows = ov_rows
        self.payload = payload


class DeviceEmbeddingCache:

    # every listed attribute is touched only under self._lock
    _GUARDED_BY = {
        "_id_of": "_lock", "_freq": "_lock", "_next_free": "_lock",
        "_sorted_ids": "_lock", "_sorted_slots": "_lock",
        "_pending": "_lock", "_pending_plan": "_lock",
        "hits": "_lock", "misses": "_lock",
    }

    def __init__(self, capacity: int, dim: int, *,
                 fetch_fn: Callable[[np.ndarray], np.ndarray],
                 decay: float = 0.99, shards: int = 1,
                 payload_dtype: str = "f32", device: DeviceLike = None):
        """``fetch_fn(missing_ids) -> rows`` pulls from VDB/PDB."""
        self.capacity = capacity
        self.dim = dim
        self.fetch_fn = fetch_fn
        self.decay = decay
        self.payload_dtype = payload_dtype
        self._store = ShardedPayloadStore(capacity, dim, shards=shards,
                                          payload_dtype=payload_dtype,
                                          device=device)
        self.device = self._store.device
        self._id_of = np.full(capacity, -1, np.int64)
        self._freq = np.zeros(capacity, np.float64)
        self._next_free = 0
        self._sorted_ids = np.empty(0, np.int64)
        self._sorted_slots = np.empty(0, np.int64)
        self.hits = 0
        self.misses = 0
        self._pending: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._pending_plan: Optional[LookupPlan] = None
        self._lock = threading.RLock()

    @property
    def payload(self):
        """Current ``(payload, scales)`` snapshot (pending scatter
        flushed)."""
        with self._lock:
            self._flush_pending_locked()
            return self._store.snapshot()

    # -- host index --------------------------------------------------------------

    def _find_locked(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized id -> slot (-1 if not resident). ``ids`` unique."""
        if len(self._sorted_ids) == 0:
            return np.full(len(ids), -1, np.int64)
        pos = np.searchsorted(self._sorted_ids, ids)
        pos = np.clip(pos, 0, len(self._sorted_ids) - 1)
        found = self._sorted_ids[pos] == ids
        return np.where(found, self._sorted_slots[pos], -1)

    def _rebuild_index_locked(self) -> None:
        occ = self._id_of[:self._next_free]
        order = np.argsort(occ, kind="stable").astype(np.int64)
        self._sorted_ids = occ[order]
        self._sorted_slots = order

    # -- two-stage query ---------------------------------------------------------

    def probe(self, ids: np.ndarray) -> LookupPlan:
        """HOST stage: resolve ``ids [n]`` (-1 = pad) to payload slots,
        fetching + index-inserting misses; the payload scatter is deferred
        to ``commit``. An all-hit plan binds its snapshot at once; one
        with insertions binds when the scatter flushes (in ``commit`` or
        the next locked call on this cache, whichever is first)."""
        with self._lock:
            self._flush_pending_locked()
            slots, ov_idx, ov_rows = self._probe_locked(
                np.asarray(ids, np.int64))
            plan = LookupPlan(slots, ov_idx, ov_rows, None)
            if self._pending is None:
                plan.payload = self._store.snapshot()
            else:
                self._pending_plan = plan
            return plan

    def commit(self, plan: LookupPlan):
        """DEVICE stage: dispatch the plan's deferred scatter (if still
        pending) and return its snapshot. Gather from IT, not from
        ``self.payload``."""
        if plan.payload is None:
            with self._lock:
                self._flush_pending_locked()
        return plan.payload

    def acquire_slots(self, ids: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, tuple]:
        """Both stages back-to-back: ``(slots, ov_idx, ov_rows, payload)``."""
        plan = self.probe(ids)
        return plan.slots, plan.ov_idx, plan.ov_rows, self.commit(plan)

    def _flush_pending_locked(self) -> None:
        if self._pending is not None:
            dest, rows = self._pending
            self._pending = None
            self._scatter_locked(dest, rows)
        if self._pending_plan is not None:
            self._pending_plan.payload = self._store.snapshot()
            self._pending_plan = None

    def _probe_locked(self, ids: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = len(ids)
        empty = (np.empty(0, np.int64),
                 np.empty((0, self.dim), np.float32))
        if n == 0:
            return np.empty(0, np.int64), *empty
        valid = ids >= 0
        uniq, inv = np.unique(np.where(valid, ids, -1), return_inverse=True)
        counts = np.bincount(inv, minlength=len(uniq))
        has_pad = len(uniq) > 0 and uniq[0] < 0
        slots_u = np.full(len(uniq), -1, np.int64)
        real = slice(1, None) if has_pad else slice(None)
        slots_u[real] = self._find_locked(uniq[real])
        found = slots_u >= 0
        real_mask = uniq >= 0
        self.hits += int(counts[found].sum())
        self.misses += int(counts[real_mask & ~found].sum())
        if found.any():
            np.add.at(self._freq, slots_u[found],
                      counts[found].astype(np.float64))

        miss = real_mask & ~found
        ov_idx, ov_rows = empty
        if miss.any():
            miss_ids = uniq[miss]
            # lock-ok: LOCK002 probe fetch under the lock preserves same-table ordering; the pipelined engine keeps it off the hot thread
            rows = np.asarray(self.fetch_fn(miss_ids), np.float32)
            k = len(miss_ids)
            n_occ = self._next_free
            free = min(k, self.capacity - n_occ)
            dest_free = np.arange(n_occ, n_occ + free, dtype=np.int64)
            victims = np.empty(0, np.int64)
            if k > free:
                # batch-aware LFU eviction: age once per batch, protect
                # the slots this query reads
                self._freq[:n_occ] *= self.decay
                cost = self._freq[:n_occ].copy()
                hit_slots = slots_u[found]
                cost[hit_slots] = np.inf
                evictable = n_occ - len(np.unique(hit_slots))
                take = min(k - free, evictable)
                if take > 0:
                    victims = np.argpartition(cost, take - 1)[:take]
                    victims = victims.astype(np.int64)
            dest = np.concatenate([dest_free, victims])
            ins = len(dest)
            if ins < k:  # cache the hottest misses, overflow the rest
                order = np.argsort(-counts[miss], kind="stable")
            else:
                order = np.arange(k)
            sel, ovf = order[:ins], order[ins:]

            self._next_free = n_occ + free
            self._id_of[dest] = miss_ids[sel]
            self._freq[dest] = counts[miss][sel].astype(np.float64)
            self._rebuild_index_locked()
            if ins:  # the ONE device scatter, deferred to commit()
                self._pending = (dest, rows[sel])
            miss_slots = np.full(k, -1, np.int64)
            miss_slots[sel] = dest
            slots_u[miss] = miss_slots

            if len(ovf):
                ov_uniq = np.full(len(uniq), -1, np.int64)
                ov_pos_u = np.nonzero(miss)[0][ovf]
                ov_uniq[ov_pos_u] = np.arange(len(ovf))
                per_elem = ov_uniq[inv]
                ov_idx = np.nonzero(per_elem >= 0)[0].astype(np.int64)
                ov_rows = rows[ovf][per_elem[ov_idx]]

        return slots_u[inv].astype(np.int64), ov_idx, ov_rows

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
        spad_t = torch.from_numpy(spad.astype(np.int32)).to(self.device)
        out = self._store.gather(payload, spad_t)[:n]
        if len(ov_idx):  # rare: batch exceeded evictable capacity
            out[torch.from_numpy(ov_idx).to(self.device)] = \
                torch.from_numpy(ov_rows).to(self.device)
        return out

    def counters(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses}
