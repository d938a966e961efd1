"""Persistent database (HPS level 3) — full model copy on disk/SSD.

Copied from ``repro/core/hps/persistent_db.py``; the on-disk format is
the same (``{model}__{table}.f32`` raw f32 memmap plus a ``.json`` with
its shape), so either package reads tables the other wrote.

The paper: *"PDB layers use hard-disks/SSDs to permanently store entire
embedding tables ... backup and ultimate ground truth"*, with per-table
key namespaces. One memmap per (model, table) namespace.

One store-wide lock serializes access: the serve loop upserts online
updates while pipelined-lookup host workers and refresh fetches read the
same rows, and a torn memmap row must never reach the caches. A fetch is
one gather of the host library (``_host``) from the memmap's buffer,
under that lock.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.hps import _host


class PersistentDB:

    # the memmap handles and their shapes only move under the lock
    _GUARDED_BY = {"_maps": "_lock", "_meta": "_lock"}

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._maps: Dict[Tuple[str, str], np.memmap] = {}
        self._meta: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._lock = threading.RLock()

    def _key(self, model: str, table: str) -> Tuple[str, str]:
        return (model, table)

    def create_table(self, model: str, table: str, vocab: int, dim: int,
                     initial: np.ndarray | None = None) -> None:
        with self._lock:
            path = os.path.join(self.root, f"{model}__{table}.f32")
            mm = np.memmap(path, np.float32, "w+", shape=(vocab, dim))
            if initial is not None:
                mm[:] = initial
            mm.flush()
            self._maps[self._key(model, table)] = mm
            self._meta[self._key(model, table)] = (vocab, dim)
            with open(os.path.join(self.root, f"{model}__{table}.json"),
                      "w") as f:
                json.dump({"vocab": vocab, "dim": dim}, f)

    def open_table(self, model: str, table: str) -> None:
        with self._lock:
            path = os.path.join(self.root, f"{model}__{table}.f32")
            with open(os.path.join(self.root,
                                   f"{model}__{table}.json")) as f:
                meta = json.load(f)
            self._maps[self._key(model, table)] = np.memmap(
                path, np.float32, "r+", shape=(meta["vocab"], meta["dim"]))
            self._meta[self._key(model, table)] = (meta["vocab"],
                                                   meta["dim"])

    def fetch(self, model: str, table: str, ids: np.ndarray) -> np.ndarray:
        """``[*ids.shape, dim]`` f32 rows (a fresh array); a negative id
        counts from the end and one out of range raises ``IndexError``, as
        numpy's indexing does."""
        ids = np.asarray(ids)
        if ids.size and ids.dtype.kind not in "iu":
            raise IndexError("arrays used as indices must be of integer "
                             f"type, got {ids.dtype}")
        flat = _host.i64(ids.reshape(-1))
        with self._lock:
            mm = self._maps[self._key(model, table)]
            vocab, dim = mm.shape
            out = np.empty((len(flat), dim), np.float32)
            if len(flat) and dim:
                bad = _host.call("hps_gather_rows", _host.ptr(mm), vocab,
                                 dim, _host.ptr(flat), len(flat),
                                 _host.ptr(out))
                if bad >= 0:
                    raise IndexError(
                        f"index {int(flat[bad])} is out of bounds for axis "
                        f"0 with size {vocab}")
        return out.reshape(*ids.shape, dim)

    def upsert(self, model: str, table: str, ids: np.ndarray,
               rows: np.ndarray) -> None:
        with self._lock:
            mm = self._maps[self._key(model, table)]
            mm[ids] = rows

    def flush(self):
        with self._lock:
            for mm in self._maps.values():
                mm.flush()

    def table_shape(self, model: str, table: str) -> Tuple[int, int]:
        with self._lock:
            return self._meta[self._key(model, table)]
