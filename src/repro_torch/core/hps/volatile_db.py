"""Volatile database (HPS level 2) — distributed CPU-memory cache.

Copied from ``repro/core/hps/volatile_db.py`` (pure numpy).

Stands in for the paper's Redis-cluster VDB: embedding rows live in the
system memory of (simulated) cluster nodes, sharded by id hash, each shard
bounded by a capacity with LRU eviction. Partial copies only — misses fall
through to the persistent DB.

Vectorized to match the batched L1 path: each shard keeps its rows in a
dense ``[cap, D]`` array with a sorted id index, so a whole query resolves
with one ``np.searchsorted`` per shard and inserts are one slice-assign.
The sorted index is maintained by an *incremental merge* on insert
(victim pairs dropped, the new sorted id block spliced in) — a full
re-sort only happens on the rare explicit ``evict_ids`` compaction.
Rows are **copied** on insert and on query — the store never aliases
caller arrays (the seed kept views into the caller's row buffers, so
later in-place writes by the caller silently mutated the DB).

Access is serialized by one store-wide lock: the HPS pipelined lookup
probes tables from a host worker while the serving thread may apply
online updates or refresh fetches, and all of those paths land here.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


class _Shard:
    """One (simulated) cluster node: dense rows + sorted id index + LRU."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.rows: Optional[np.ndarray] = None     # [cap, D] lazily alloc'd
        self.id_of = np.full(capacity, -1, np.int64)
        self.tick = np.zeros(capacity, np.int64)   # LRU clock per slot
        self.n = 0
        self.sorted_ids = np.empty(0, np.int64)
        self.sorted_slots = np.empty(0, np.int64)

    def _rebuild(self) -> None:
        occ = self.id_of[:self.n]
        order = np.argsort(occ, kind="stable").astype(np.int64)
        self.sorted_ids = occ[order]
        self.sorted_slots = order

    def find(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized id -> slot (-1 missing); ``ids`` need not be unique."""
        if len(self.sorted_ids) == 0:
            return np.full(len(ids), -1, np.int64)
        pos = np.searchsorted(self.sorted_ids, ids)
        np.minimum(pos, len(self.sorted_ids) - 1, out=pos)
        return np.where(self.sorted_ids[pos] == ids,
                        self.sorted_slots[pos], -1)

    def insert(self, ids: np.ndarray, rows: np.ndarray, now: int) -> None:
        # dedup keeping the LAST occurrence: batched online updates
        # concatenate chronologically, so the newest row must win
        uniq, idx_rev = np.unique(ids[::-1], return_index=True)
        ids, rows = uniq, rows[len(rows) - 1 - idx_rev]
        if self.rows is None:
            self.rows = np.zeros((self.capacity, rows.shape[1]), np.float32)
        slots = self.find(ids)
        hit = slots >= 0
        if hit.any():  # update in place (copies — no aliasing)
            self.rows[slots[hit]] = rows[hit]
            self.tick[slots[hit]] = now
        new_ids, new_rows = ids[~hit], rows[~hit]
        k = len(new_ids)
        if k == 0:
            return
        free = min(k, self.capacity - self.n)
        dest = np.arange(self.n, self.n + free, dtype=np.int64)
        victims = np.empty(0, np.int64)
        if k > free:  # LRU eviction, all victims in one argpartition
            take = min(k - free, self.n)
            if take > 0:
                victims = np.argpartition(self.tick[:self.n],
                                          take - 1)[:take].astype(np.int64)
                dest = np.concatenate([dest, victims])
        sel = np.arange(len(dest))
        # incremental sorted merge, NOT a per-batch re-sort: drop the
        # victims' (id, slot) pairs, then splice the new id block in at
        # its searchsorted positions — O(n + b log n) per batch instead
        # of O(n log n), the dominant host cost of the L2 promote path
        # at high miss rates. new_ids is np.unique output, so the
        # spliced block is already sorted.
        base_ids, base_slots = self.sorted_ids, self.sorted_slots
        if len(victims):
            vpos = np.searchsorted(base_ids, self.id_of[victims])
            keep = np.ones(len(base_ids), bool)
            keep[vpos] = False
            base_ids, base_slots = base_ids[keep], base_slots[keep]
        add_ids = new_ids[sel]
        ins = np.searchsorted(base_ids, add_ids)
        self.sorted_ids = np.insert(base_ids, ins, add_ids)
        self.sorted_slots = np.insert(base_slots, ins, dest)
        self.n += free
        self.id_of[dest] = add_ids
        self.rows[dest] = new_rows[sel]
        self.tick[dest] = now

    def evict_ids(self, ids: np.ndarray) -> None:
        slots = self.find(np.unique(ids))
        slots = slots[slots >= 0]
        if len(slots) == 0:
            return
        # compact the occupied prefix so self.n stays the watermark
        keep = np.setdiff1d(np.arange(self.n), slots)
        m = len(keep)
        self.id_of[:m] = self.id_of[keep]
        if self.rows is not None:
            self.rows[:m] = self.rows[keep]
        self.tick[:m] = self.tick[keep]
        self.id_of[m:self.n] = -1
        self.n = m
        self._rebuild()


class VolatileDB:

    # shard state, the LRU clock and the hit/miss counters are all
    # behind the one store-wide lock
    _GUARDED_BY = {
        "_store": "_lock", "_now": "_lock",
        "hits": "_lock", "misses": "_lock",
    }

    def __init__(self, *, shards: int = 1, capacity_per_shard: int = 100000):
        self.shards = shards
        self.capacity = capacity_per_shard
        self._store: Dict[str, List[_Shard]] = {}  # table -> shard list
        self._now = 0
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def _ns_locked(self, table: str) -> List[_Shard]:
        if table not in self._store:
            self._store[table] = [_Shard(self.capacity)
                                  for _ in range(self.shards)]
        return self._store[table]

    def query(self, table: str, ids: np.ndarray
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Returns (found_mask, rows) — rows is None if nothing found.

        ``rows`` is freshly allocated (never a view into the store).
        """
        with self._lock:
            return self._query_locked(table, ids)

    def _query_locked(self, table: str, ids: np.ndarray
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        ns = self._ns_locked(table)
        ids = np.asarray(ids, np.int64)
        self._now += 1
        mask = np.zeros(len(ids), bool)
        rows = None
        shard_of = ids % self.shards
        for s, shard in enumerate(ns):
            in_s = np.nonzero(shard_of == s)[0]
            if len(in_s) == 0 or shard.rows is None:
                continue
            slots = shard.find(ids[in_s])
            hit = slots >= 0
            if not hit.any():
                continue
            if rows is None:
                rows = np.zeros((len(ids), shard.rows.shape[1]), np.float32)
            rows[in_s[hit]] = shard.rows[slots[hit]]
            shard.tick[slots[hit]] = self._now       # LRU touch
            mask[in_s] = hit
        self.hits += int(mask.sum())
        self.misses += int((~mask).sum())
        return mask, rows

    def insert(self, table: str, ids: np.ndarray, rows: np.ndarray) -> None:
        with self._lock:
            ns = self._ns_locked(table)
            ids = np.asarray(ids, np.int64)
            rows = np.asarray(rows, np.float32)
            self._now += 1
            shard_of = ids % self.shards
            for s, shard in enumerate(ns):
                in_s = np.nonzero(shard_of == s)[0]
                if len(in_s):
                    shard.insert(ids[in_s], rows[in_s].copy(), self._now)

    def evict(self, table: str, ids: np.ndarray) -> None:
        with self._lock:
            ns = self._ns_locked(table)
            ids = np.asarray(ids, np.int64)
            shard_of = ids % self.shards
            for s, shard in enumerate(ns):
                in_s = np.nonzero(shard_of == s)[0]
                if len(in_s):
                    shard.evict_ids(ids[in_s])

    def size(self, table: str) -> int:
        with self._lock:
            return sum(s.n for s in self._ns_locked(table))

    def stats(self) -> Dict:
        """Per-table occupancy for the serving L1/L2/L3 picture."""
        with self._lock:
            cap = self.shards * self.capacity
            tables = {t: {"rows": sum(s.n for s in shards),
                          "fill": sum(s.n for s in shards) / cap}
                      for t, shards in self._store.items()}
            return {"hits": self.hits, "misses": self.misses,
                    "shards": self.shards, "capacity_per_shard":
                    self.capacity, "tables": tables}
