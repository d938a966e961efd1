"""Volatile database (HPS level 2) — distributed CPU-memory cache.

Ported from ``repro/core/hps/volatile_db.py`` (pure numpy).

Stands in for the paper's Redis-cluster VDB: embedding rows live in the
system memory of (simulated) cluster nodes, sharded by id hash, each shard
bounded by a capacity with LRU eviction. Partial copies only — misses fall
through to the persistent DB.

Vectorized to match the batched L1 path: each shard keeps its rows in a
dense ``[cap, D]`` array with an id -> slot index, so a whole query
resolves with one search per shard and inserts are one slice-assign. The
index is an exact hash map (``id_index.IdIndex``), searched and updated in
time that grows with the ids of the call; the reference keeps a sorted id
array and splices every insert into it. A shard's query (the search, the
LRU touch, the row copy) and its insert of sorted unique ids (an L1
probe's misses: the in-place update of residents, the append into free
slots, the index update) are each one call into the host library
(``_host``). The decisions are the
reference's: the dedup keeps the last occurrence, the LRU victims come
from the same numpy ``argpartition`` over the same order of ticks, and
the rare explicit ``evict_ids`` compacts the shard. Rows are **copied**
on insert and on query — the store never aliases caller arrays (the seed
kept views into the caller's row buffers, so later in-place writes by
the caller silently mutated the DB).

Each namespace (a model's table) has a lock of its own and its own LRU
clock, so the HPS host workers probing different tables, and the serving
thread applying online updates or refresh fetches, do not wait for each
other. A namespace's clock ticks once per query or insert on it, as the
reference's one store-wide clock does: within a namespace the ticks keep
the reference's order and ties, which is all ``argpartition`` compares.
The namespace map and the hit / miss counters keep a lock of their own.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.hps import _host
from repro_torch.core.hps.id_index import IdIndex


class _Shard:
    """One (simulated) cluster node: dense rows + id index + LRU."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.rows: Optional[np.ndarray] = None     # [cap, D] lazily alloc'd
        self.id_of = np.full(capacity, -1, np.int64)
        self.tick = np.zeros(capacity, np.int64)   # LRU clock per slot
        self.n = 0
        self.index = IdIndex()

    @property
    def sorted_ids(self) -> np.ndarray:
        """The resident ids, sorted: the reference's index array."""
        return self.index.sorted_view()[0]

    @property
    def sorted_slots(self) -> np.ndarray:
        """The slot of each of :attr:`sorted_ids`."""
        return self.index.sorted_view()[1]

    def _rebuild(self) -> None:
        self.index = IdIndex(self.id_of[:self.n],
                             np.arange(self.n, dtype=np.int64))

    def find(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized id -> slot (-1 missing); ``ids`` need not be unique."""
        return self.index.find(ids)

    def query_into(self, ids: np.ndarray, pos: Optional[np.ndarray],
                   now: int, rows: np.ndarray, mask: np.ndarray) -> int:
        """Search ``ids[pos]`` (all of ``ids`` when None): each resident
        id's row copied into ``rows`` at its position, its tick set to
        ``now``, its ``mask`` entry set. Returns the hits."""
        m = len(ids) if pos is None else len(pos)
        return _host.call("hps_l2_query", self.index.handle, _host.ptr(ids),
            None if pos is None else _host.ptr(pos), m,
            _host.ptr(self.rows), self.rows.shape[1], _host.ptr(self.tick),
            now, _host.ptr(rows), _host.ptr(mask))

    def insert(self, ids: np.ndarray, rows: np.ndarray, now: int,
               info) -> None:
        """Insert ``ids`` with ``rows`` at LRU time ``now``: residents
        updated in place, the rest into free slots, then over the least
        recently used. ``info`` is the caller's ``_host.info_buffer``."""
        ids = _host.i64(ids)
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"rows of shape {rows.shape}: want [n, D]")
        if self.rows is None:
            self.rows = np.zeros((self.capacity, rows.shape[1]), np.float32)
        if rows.shape != (len(ids), self.rows.shape[1]):
            # the host passes copy len(ids) rows of the shard's width
            raise ValueError(f"rows of shape {rows.shape} for {len(ids)} "
                             f"ids of width {self.rows.shape[1]}")
        miss = np.empty(len(ids), np.int64)
        dim = rows.shape[1]
        rc = self._insert_sorted(ids, rows, miss, now, info)
        if rc == 1:
            # dedup keeping the LAST occurrence: batched online updates
            # concatenate chronologically, so the newest row must win (ids
            # already sorted and unique, as an L1 probe's misses, pass)
            uniq, idx_rev = np.unique(ids[::-1], return_index=True)
            ids, rows = uniq, rows[len(rows) - 1 - idx_rev]
            rc = self._insert_sorted(ids, rows, miss, now, info)
        _host.check("hps_l2_insert", rc)
        k, placed = info[:2]
        if k == 0 or placed:
            if placed:
                self.n += k
            return
        # more new ids than free slots: the LRU victims, then one place
        free = self.capacity - self.n
        dest = np.arange(self.n, self.capacity, dtype=np.int64)
        victims = self._lru_victims(k - free)
        if len(victims):
            dest = _host.i64(np.concatenate([dest, victims]))
        if len(dest):
            rc = _host.call("hps_l2_place", self.index.handle, _host.ptr(ids),
                _host.ptr(rows), _host.ptr(miss), _host.ptr(dest),
                len(dest), free, dim, _host.ptr(self.rows),
                _host.ptr(self.tick), _host.ptr(self.id_of), now)
            if rc > 0:
                raise KeyError(f"victim slot {int(dest[free + rc - 1])} "
                               "held no indexed id")
            _host.check("hps_l2_place", rc)
        self.n += free

    def _insert_sorted(self, ids, rows, miss, now, info) -> int:
        """One ``hps_l2_insert`` call (1: the ids are not sorted and
        unique, nothing done)."""
        return _host.call("hps_l2_insert", self.index.handle, _host.ptr(ids),
            _host.ptr(rows), len(ids), rows.shape[1], _host.ptr(self.rows),
            _host.ptr(self.tick), _host.ptr(self.id_of), now, self.n,
            self.capacity, _host.ptr(miss), info)

    def _lru_victims(self, want: int) -> np.ndarray:
        """Up to ``want`` least recently used slots, all in one
        ``argpartition`` over the ticks."""
        take = min(want, self.n)
        if take <= 0:
            return np.empty(0, np.int64)
        return np.argpartition(self.tick[:self.n],
                               take - 1)[:take].astype(np.int64)

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


class _Namespace:
    """One table's shards, under a lock of its own, with its own LRU
    clock."""

    _GUARDED_BY = {"_shards": "_lock", "_now": "_lock", "_info": "_lock"}

    def __init__(self, shards: int, capacity: int):
        self._shards = [_Shard(capacity) for _ in range(shards)]
        self._now = 0
        self._info = _host.info_buffer()
        self._lock = threading.RLock()

    def _split_locked(self, ids: np.ndarray
                      ) -> List[Tuple[_Shard, Union[slice, np.ndarray]]]:
        """``(shard, positions of its ids)`` for each shard that ``ids``
        hash to; a single shard takes every position (a slice)."""
        if len(self._shards) == 1:
            return [(self._shards[0], slice(None))] if len(ids) else []
        shard_of = ids % len(self._shards)
        out = []
        for s, shard in enumerate(self._shards):
            in_s = np.nonzero(shard_of == s)[0]
            if len(in_s):
                out.append((shard, in_s))
        return out

    def query(self, ids: np.ndarray
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        with self._lock:
            self._now += 1
            mask = np.zeros(len(ids), bool)
            rows, hits = None, 0
            for shard, in_s in self._split_locked(ids):
                if shard.rows is None:
                    continue
                if rows is None:
                    rows = np.zeros((len(ids), shard.rows.shape[1]),
                                    np.float32)
                # the search, the LRU touch and the row copy: one call
                hits += shard.query_into(
                    ids, None if isinstance(in_s, slice) else in_s,
                    self._now, rows, mask)
            return mask, rows if hits else None

    def insert(self, ids: np.ndarray, rows: np.ndarray) -> None:
        with self._lock:
            self._now += 1
            for shard, in_s in self._split_locked(ids):
                # the shard copies the rows into its own array
                shard.insert(ids[in_s], rows[in_s], self._now, self._info)

    def evict(self, ids: np.ndarray) -> None:
        with self._lock:
            for shard, in_s in self._split_locked(ids):
                shard.evict_ids(ids[in_s])

    def size(self) -> int:
        with self._lock:
            return sum(s.n for s in self._shards)


class VolatileDB:

    # the namespace map and the hit / miss counters are behind the
    # store's lock; each namespace's shards and clock behind its own
    _GUARDED_BY = {
        "_spaces": "_lock", "hits": "_lock", "misses": "_lock",
    }

    def __init__(self, *, shards: int = 1, capacity_per_shard: int = 100000):
        self.shards = shards
        self.capacity = capacity_per_shard
        self._spaces: Dict[str, _Namespace] = {}
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def _space(self, table: str) -> _Namespace:
        with self._lock:
            ns = self._spaces.get(table)
            if ns is None:
                ns = self._spaces[table] = _Namespace(self.shards,
                                                      self.capacity)
            return ns

    def query(self, table: str, ids: np.ndarray
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Returns (found_mask, rows) — rows is None if nothing found.

        ``rows`` is freshly allocated (never a view into the store).
        """
        ids = _host.i64(ids)
        mask, rows = self._space(table).query(ids)
        n_hit = int(mask.sum())
        with self._lock:
            self.hits += n_hit
            self.misses += len(ids) - n_hit
        return mask, rows

    def insert(self, table: str, ids: np.ndarray, rows: np.ndarray) -> None:
        self._space(table).insert(np.asarray(ids, np.int64),
                                  np.asarray(rows, np.float32))

    def evict(self, table: str, ids: np.ndarray) -> None:
        self._space(table).evict(np.asarray(ids, np.int64))

    def size(self, table: str) -> int:
        return self._space(table).size()

    def stats(self) -> Dict:
        """Per-table occupancy for the serving L1/L2/L3 picture."""
        with self._lock:
            spaces = list(self._spaces.items())
            hits, misses = self.hits, self.misses
        cap = self.shards * self.capacity
        tables = {}
        for t, ns in spaces:
            rows = ns.size()
            tables[t] = {"rows": rows, "fill": rows / cap}
        return {"hits": hits, "misses": misses, "shards": self.shards,
                "capacity_per_shard": self.capacity, "tables": tables}
