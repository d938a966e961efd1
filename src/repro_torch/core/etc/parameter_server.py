"""Training-side parameter servers for the Embedding Training Cache,
copied from ``repro/core/etc/parameter_server.py`` (numpy only): the same
pushes and pulls leave the same bytes in either package's PS, the default
rows of a never-pushed id included (one ``np.random.default_rng(seed)``
stream per PS).

Two tiers, mirroring the paper (§1 "Online training"):
  * ``StagedPS``  — full tables in (distributed) host memory.
  * ``CachedPS``  — full tables on disk / NFS via ``np.memmap``; host memory
    only holds what is being exchanged.

Both expose batched ``pull(table, ids) -> rows`` and
``push(table, ids, rows)`` — one vectorized index operation per call, no
per-id Python loops — plus ``pull_state``/``push_state`` for the row-wise
optimizer accumulator, so an evicted-and-repulled row resumes training
with its momentum intact. Rows not yet trained are served from the
initializer so pulls never fail.

Concurrency: both PS tiers are confined to the training thread (the ETC
staging step is the only caller); the serving stack never touches them —
online updates reach inference by value over the message bus.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.configs.base import EmbeddingTableConfig


class _Shard:
    """Sorted-id row store: every batched op is one ``searchsorted``."""

    __slots__ = ("ids", "rows")

    def __init__(self, dim: int):
        self.ids = np.empty(0, np.int64)
        self.rows = np.empty((0, dim), np.float32)

    def insert(self, new_ids: np.ndarray, new_rows: np.ndarray) -> None:
        """Merge (sorted, unique, disjoint) new ids into the store."""
        pos = np.searchsorted(self.ids, new_ids)
        self.ids = np.insert(self.ids, pos, new_ids)
        self.rows = np.insert(self.rows, pos, new_rows, axis=0)

    def locate(self, ids: np.ndarray) -> np.ndarray:
        """Positions of ``ids`` (must all be present)."""
        return np.searchsorted(self.ids, ids)

    def member_mask(self, ids: np.ndarray) -> np.ndarray:
        if self.ids.size == 0:
            return np.zeros(ids.size, bool)
        pos = np.searchsorted(self.ids, ids)
        inb = pos < self.ids.size
        mask = np.zeros(ids.size, bool)
        mask[inb] = self.ids[pos[inb]] == ids[inb]
        return mask


def _dedupe_keep_last(ids: np.ndarray, rows: np.ndarray):
    """Unique ids keeping the LAST row pushed for a duplicate (matches
    the sequential-overwrite semantics of the old per-id loop)."""
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    keep = np.r_[sid[1:] != sid[:-1], True] if sid.size else \
        np.empty(0, bool)
    return sid[keep], rows[order][keep]


class StagedPS:
    """Host-memory PS. ``shards`` simulates spreading over cluster nodes."""

    def __init__(self, tables: Sequence[EmbeddingTableConfig], *,
                 seed: int = 0, shards: int = 1):
        self.tables = {t.name: t for t in tables}
        self.shards = shards
        self._shards: Dict[str, List[_Shard]] = {
            t.name: [_Shard(t.dim) for _ in range(shards)]
            for t in tables}
        # optimizer state (one f32 scalar per row), same sharding
        self._state: Dict[str, List[_Shard]] = {
            t.name: [_Shard(1) for _ in range(shards)] for t in tables}
        self._rng = np.random.default_rng(seed)
        self._init_scale = {t.name: 1.0 / np.sqrt(t.vocab_size)
                            for t in tables}

    def _default_rows(self, table: str, n: int) -> np.ndarray:
        d = self.tables[table].dim
        s = self._init_scale[table]
        return self._rng.uniform(-s, s, (n, d)).astype(np.float32)

    def pull(self, table: str, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        d = self.tables[table].dim
        out = np.empty((ids.size, d), np.float32)
        for k, sh in enumerate(self._shards[table]):
            local_idx = np.flatnonzero(ids % self.shards == k)
            if local_idx.size == 0:
                continue
            local = ids[local_idx]
            found = sh.member_mask(local)
            if not found.all():
                new = np.unique(local[~found])
                sh.insert(new, self._default_rows(table, new.size))
            out[local_idx] = sh.rows[sh.locate(local)]
        return out

    def push(self, table: str, ids: np.ndarray, rows: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        rows = np.asarray(rows, np.float32)
        self._scatter(self._shards[table], ids, rows)

    def _scatter(self, shards: List[_Shard], ids: np.ndarray,
                 rows: np.ndarray) -> None:
        for k, sh in enumerate(shards):
            local_idx = np.flatnonzero(ids % self.shards == k)
            if local_idx.size == 0:
                continue
            uid, urows = _dedupe_keep_last(ids[local_idx],
                                           rows[local_idx])
            found = sh.member_mask(uid)
            if found.any():
                sh.rows[sh.locate(uid[found])] = urows[found]
            if not found.all():
                sh.insert(uid[~found], urows[~found])

    # -- optimizer-state round-trip (rowwise accumulator) -------------------

    def pull_state(self, table: str, ids: np.ndarray) -> np.ndarray:
        """Row-wise accumulator for ``ids`` (0 for never-pushed rows)."""
        ids = np.asarray(ids, np.int64)
        out = np.zeros(ids.size, np.float32)
        for k, sh in enumerate(self._state[table]):
            local_idx = np.flatnonzero(ids % self.shards == k)
            if local_idx.size == 0:
                continue
            local = ids[local_idx]
            found = sh.member_mask(local)
            if found.any():
                out[local_idx[found]] = \
                    sh.rows[sh.locate(local[found]), 0]
        return out

    def push_state(self, table: str, ids: np.ndarray,
                   acc: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        acc = np.asarray(acc, np.float32).reshape(-1, 1)
        self._scatter(self._state[table], ids, acc)

    def resident_rows(self, table: str) -> int:
        return sum(s.ids.size for s in self._shards[table])


class CachedPS:
    """Disk-backed PS: one memmap per table (scales to SSD/NFS capacity).

    ``flush()`` is durability-safe: after ``memmap.flush`` (msync) every
    backing file is ``os.fsync``'d, so a crash after flush() cannot lose
    acknowledged pushes to the page cache.
    """

    def __init__(self, tables: Sequence[EmbeddingTableConfig], root: str, *,
                 seed: int = 0):
        self.root = root
        self.tables = {t.name: t for t in tables}
        os.makedirs(root, exist_ok=True)
        self._maps: Dict[str, np.memmap] = {}
        self._state_maps: Dict[str, np.memmap] = {}
        self._paths: Dict[str, str] = {}
        rng = np.random.default_rng(seed)
        for t in tables:
            path = os.path.join(root, f"{t.name}.f32")
            fresh = not os.path.exists(path)
            mm = np.memmap(path, np.float32, "r+" if not fresh else "w+",
                           shape=(t.vocab_size, t.dim))
            if fresh:
                s = 1.0 / np.sqrt(t.vocab_size)
                chunk = 1 << 16
                for lo in range(0, t.vocab_size, chunk):
                    hi = min(t.vocab_size, lo + chunk)
                    mm[lo:hi] = rng.uniform(-s, s, (hi - lo, t.dim)) \
                        .astype(np.float32)
                mm.flush()
            self._maps[t.name] = mm
            self._paths[path] = path
            spath = os.path.join(root, f"{t.name}.acc.f32")
            sfresh = not os.path.exists(spath)
            smm = np.memmap(spath, np.float32,
                            "r+" if not sfresh else "w+",
                            shape=(t.vocab_size,))
            if sfresh:
                smm[:] = 0.0
                smm.flush()
            self._state_maps[t.name] = smm
            self._paths[spath] = spath
        with open(os.path.join(root, "meta.json"), "w") as f:
            json.dump({t.name: {"vocab": t.vocab_size, "dim": t.dim}
                       for t in tables}, f)

    def pull(self, table: str, ids: np.ndarray) -> np.ndarray:
        return np.asarray(self._maps[table][ids], np.float32)

    def push(self, table: str, ids: np.ndarray, rows: np.ndarray) -> None:
        self._maps[table][ids] = rows

    def pull_state(self, table: str, ids: np.ndarray) -> np.ndarray:
        return np.asarray(self._state_maps[table][ids], np.float32)

    def push_state(self, table: str, ids: np.ndarray,
                   acc: np.ndarray) -> None:
        self._state_maps[table][ids] = np.asarray(acc, np.float32)

    def flush(self):
        for mm in (*self._maps.values(), *self._state_maps.values()):
            mm.flush()
        for path in self._paths.values():
            with open(path, "rb+") as f:
                os.fsync(f.fileno())
