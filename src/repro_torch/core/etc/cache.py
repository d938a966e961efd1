"""Embedding Training Cache (ETC) — train tables larger than device memory
(counterpart of ``repro/core/etc/cache.py``).

The device holds a fixed-capacity row cache per table (``cache [T, C, D]``
f32 params + ``acc [T, C]`` f32 row-wise optimizer state, tensors on the
cache's device). Before each step the host:

  1. collects the batch's unique ids per table,
  2. evicts least-recently-used rows to make space, reading only the
     victims' rows back (one K5 row read of params and one of state) and
     writing them to the PS in ONE batched push,
  3. pulls missing rows from the PS in ONE batched pull into free slots:
     one host-to-device copy of the rows with their accumulators, one of
     their slots, and one in-place ``index_put_`` per table,
  4. remaps batch ids -> cache slots with ONE ``np.searchsorted`` over
     the whole ``[B, H]`` block.

The host index is the reference's, copied: per table a pair of sorted
NumPy arrays (ids / slots) plus an LRU stamp per slot, the deterministic
``lexsort`` victim choice, and the touched keyset; so the same id stream
gives the same slots, evictions and PS contents in both packages.

The device step then runs on the cache like a normal (small) embedding
table (:func:`cached_lookup`: K1 forward, K3 backward over the flattened
``[T*C, D]`` cache). ``flush()`` writes every resident row back; the
touched keyset feeds the online-update publisher
(``repro_torch.online.UpdatePublisher``).

Concurrency: the ETC is confined to the training thread (its tensors are
updated in place between steps, after the step's backward); nothing here
is shared with the serving stack — published updates travel by value
over the message bus.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import embedding_lookup_ref


class EmbeddingTrainingCache:

    def __init__(self, tables: Sequence[EmbeddingTableConfig],
                 capacity: int, ps, *, device: DeviceLike = None):
        max_vocab = max(t.vocab_size for t in tables)
        if capacity > max_vocab:
            warnings.warn(
                f"ETC cache capacity {capacity} exceeds the largest "
                f"table vocab {max_vocab}; clamping to {max_vocab} — a "
                "cache row beyond a table's vocab can never be resident",
                RuntimeWarning, stacklevel=2)
            capacity = max_vocab
        else:
            small = [t.name for t in tables if t.vocab_size < capacity]
            if small:
                warnings.warn(
                    f"table(s) {small} have vocab < ETC cache capacity "
                    f"{capacity}: they fit entirely, the surplus rows "
                    "stay unused", RuntimeWarning, stacklevel=2)
        # the kernels address the flattened cache with int32 rows
        if len(tables) * capacity >= 2 ** 31:
            raise ValueError(
                f"ETC cache of {len(tables)} tables x {capacity} rows "
                "exceeds the int32 row ids of the pooled lookup")
        self.tables = tuple(tables)
        self.capacity = capacity
        self.ps = ps
        self.device = resolve_device(device)
        # per-table residency state, all array-valued:
        #   _slot_ids[ti][slot] = resident id (-1 free)
        #   _last_used[ti][slot] = LRU stamp (prepare() clock)
        #   _sorted_ids/_sorted_slots[ti] = the searchsorted index
        self._slot_ids: List[np.ndarray] = [
            np.full(capacity, -1, np.int64) for _ in tables]
        self._last_used: List[np.ndarray] = [
            np.zeros(capacity, np.int64) for _ in tables]
        self._sorted_ids: List[np.ndarray] = [
            np.empty(0, np.int64) for _ in tables]
        self._sorted_slots: List[np.ndarray] = [
            np.empty(0, np.int64) for _ in tables]
        # ids staged since the last drain_touched() — the full keyset a
        # training pass touched, INCLUDING rows evicted mid-pass (the
        # resident set alone under-reports what an online update must
        # publish)
        self._touched: List[List[np.ndarray]] = [[] for _ in tables]
        self._clock = 0
        self.evictions = 0
        self.pulls = 0

    # -- device-side params --------------------------------------------------

    def init_params(self) -> Dict[str, torch.Tensor]:
        d = self.tables[0].dim
        assert all(t.dim == d for t in self.tables)
        return {
            "cache": torch.zeros((len(self.tables), self.capacity, d),
                                 dtype=torch.float32, device=self.device),
            "acc": torch.zeros((len(self.tables), self.capacity),
                               dtype=torch.float32, device=self.device),
        }

    # -- residency index helpers ---------------------------------------------

    def _rebuild_index(self, ti: int) -> None:
        slot_ids = self._slot_ids[ti]
        res = np.flatnonzero(slot_ids >= 0)
        order = np.argsort(slot_ids[res], kind="stable")
        self._sorted_ids[ti] = slot_ids[res][order]
        self._sorted_slots[ti] = res[order]

    def _residency(self, ti: int, uniq: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(resident mask over ``uniq``, slots of the resident ids)."""
        sids = self._sorted_ids[ti]
        if sids.size == 0:
            return np.zeros(uniq.size, bool), np.empty(0, np.int64)
        pos = np.searchsorted(sids, uniq)
        inb = pos < sids.size
        mask = np.zeros(uniq.size, bool)
        mask[inb] = sids[pos[inb]] == uniq[inb]
        return mask, self._sorted_slots[ti][pos[mask]]

    def resident_ids(self, table_idx: int) -> np.ndarray:
        """Ids currently resident for one table (sorted)."""
        return self._sorted_ids[table_idx].copy()

    def _read_rows(self, params: Dict[str, torch.Tensor], ti: int,
                   slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of the params ``[n, D]`` and accumulators ``[n]``
        at ``slots`` of table ``ti``: a K5 row read of each (the
        accumulators as a one-column table), never the whole cache."""
        idx = to_device(slots.astype(np.int32), self.device)
        rows = kops.cache_gather(params["cache"][ti], idx)
        acc = kops.cache_gather(params["acc"][ti].unsqueeze(1), idx)
        return rows.cpu().numpy(), acc[:, 0].cpu().numpy()

    # -- the host-side staging step -------------------------------------------

    def prepare(self, params: Dict[str, torch.Tensor], cat: np.ndarray
                ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
        """Ensure residency for ``cat [B, T, H]``; returns the params
        (updated in place) and the remapped ids."""
        cache = params["cache"]
        acc = params["acc"]
        remapped = np.full_like(cat, -1)
        self._clock += 1
        for ti, t in enumerate(self.tables):
            ids = np.asarray(cat[:, ti, :], np.int64)
            valid = ids >= 0
            uniq = np.unique(ids[valid])
            if uniq.size > self.capacity:
                raise ValueError(
                    f"table {t.name}: batch needs {uniq.size} unique rows "
                    f"> cache capacity {self.capacity}")
            if uniq.size:
                self._touched[ti].append(uniq)
            slot_ids = self._slot_ids[ti]
            last = self._last_used[ti]
            res_mask, res_slots = self._residency(ti, uniq)
            missing = uniq[~res_mask]
            # stamp resident ids needed by THIS batch first, so eviction
            # below can never pick them (regression: a current-batch id
            # evicted to make room broke the remap)
            last[res_slots] = self._clock
            free = np.flatnonzero(slot_ids < 0)
            need = missing.size - free.size
            if need > 0:
                evictable = np.flatnonzero(
                    (slot_ids >= 0) & (last < self._clock))
                # deterministic victim choice: oldest stamp first, slot
                # index breaking ties (lexsort: last key is primary)
                order = np.lexsort((evictable, last[evictable]))
                victims = evictable[order[:need]]
                evict_ids = slot_ids[victims]
                rows, st = self._read_rows(params, ti, victims)
                self.ps.push(t.name, evict_ids, rows)
                if hasattr(self.ps, "push_state"):
                    self.ps.push_state(t.name, evict_ids, st)
                slot_ids[victims] = -1
                last[victims] = 0
                self.evictions += need
                free = np.flatnonzero(slot_ids < 0)
            if missing.size:
                slots = free[:missing.size]
                buf = np.empty((missing.size, cache.shape[-1] + 1),
                               np.float32)
                buf[:, :-1] = self.ps.pull(t.name, missing)
                if hasattr(self.ps, "pull_state"):
                    buf[:, -1] = self.ps.pull_state(t.name, missing)
                else:
                    buf[:, -1] = 0.0
                # one copy of the rows with their accumulators, and ONE
                # in-place scatter of each into this table's cache
                dbuf = to_device(buf, self.device)
                idx = to_device(slots, self.device)
                cache[ti].index_put_((idx,), dbuf[:, :-1])
                acc[ti].index_put_((idx,), dbuf[:, -1])
                slot_ids[slots] = missing
                last[slots] = self._clock
                self.pulls += missing.size
            self._rebuild_index(ti)
            # ONE searchsorted remaps the whole [B, H] block
            sids = self._sorted_ids[ti]
            if sids.size:
                probe = np.where(valid, ids, sids[0])
                pos = np.searchsorted(sids, probe)
                slots_of = self._sorted_slots[ti][
                    np.minimum(pos, sids.size - 1)]
                remapped[:, ti, :] = np.where(valid, slots_of, -1)
        return {"cache": cache, "acc": acc}, remapped

    def flush(self, params: Dict[str, torch.Tensor]) -> None:
        """Write every resident row (and optimizer state) back to the PS
        — one batched push per table."""
        for ti, t in enumerate(self.tables):
            ids = self._sorted_ids[ti]
            if ids.size == 0:
                continue
            rows, st = self._read_rows(params, ti, self._sorted_slots[ti])
            self.ps.push(t.name, ids, rows)
            if hasattr(self.ps, "push_state"):
                self.ps.push_state(t.name, ids, st)

    def drain_touched(self, table_idx: int) -> np.ndarray:
        """Sorted unique ids staged since the last drain — a pass's full
        keyset. After ``flush()`` the PS holds every one of these ids'
        trained value (evicted rows were written back at eviction time),
        so ``ps.pull`` over this set is the complete online-update feed."""
        if not self._touched[table_idx]:
            return np.empty(0, np.int64)
        out = np.unique(np.concatenate(self._touched[table_idx]))
        self._touched[table_idx] = []
        return out

    def dirty_rows(self, params: Dict[str, torch.Tensor], table_idx: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, rows) currently resident — the online-update feed."""
        ids = self._sorted_ids[table_idx]
        rows, _ = self._read_rows(params, table_idx,
                                  self._sorted_slots[table_idx])
        return ids.copy(), rows


def cached_lookup(params: Dict[str, torch.Tensor], remapped: torch.Tensor,
                  *, use_kernels: bool = True) -> torch.Tensor:
    """Sum-pooled lookup on the cache: ``remapped [B, T, H]`` slots (-1
    pad) -> ``[B, T, D]`` f32, every table summed whatever its combiner
    (as the reference's). The cache is read as one ``[T*C, D]`` table with
    table ``t``'s slots offset by ``t*C``: one K1 launch forward and one
    K3 launch backward for all tables (``kops.fused_embedding_lookup``);
    ``use_kernels=False`` runs the plain version on any device."""
    cache = params["cache"]                          # [T, C, D]
    t, c, d = cache.shape
    b, h = remapped.shape[0], remapped.shape[-1]
    off = torch.arange(t, dtype=torch.int32,
                       device=remapped.device).view(1, t, 1) * c
    rows = torch.where(remapped >= 0, remapped.to(torch.int32) + off,
                       torch.full_like(remapped, -1, dtype=torch.int32))
    rows = rows.reshape(b * t, h)
    flat = cache.view(t * c, d)
    if use_kernels:
        out = kops.fused_embedding_lookup(flat, rows)
    else:
        out = embedding_lookup_ref(flat, rows)
    return out.reshape(b, t, d)
