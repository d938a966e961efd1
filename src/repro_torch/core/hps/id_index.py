"""The exact id -> slot map behind the HPS host indexes (the L1 cache's
and each L2 shard's).

The reference keeps each index as a sorted id array with its slots, and
merges every change into it: a pass over all the residents on every
call that inserts. Here the map is a hash table (a ``dict``), so a
search or an update costs time in the ids of the call, not in the
residents. Any exact map answers every search the same way, so the
callers' slot decisions (made from their own LFU counters or LRU ticks)
are the reference's. :meth:`IdIndex.sorted_view` gives the reference's
sorted ``(ids, slots)`` arrays.
"""
from __future__ import annotations

from itertools import repeat
from typing import Optional, Tuple

import numpy as np


class IdIndex:
    """Unique int ids -> int slots. Not thread-safe: the owner's lock
    guards it."""

    __slots__ = ("_slot_of",)

    def __init__(self, ids: Optional[np.ndarray] = None,
                 slots: Optional[np.ndarray] = None):
        """The map of ``ids[i] -> slots[i]`` (empty when None)."""
        self._slot_of = ({} if ids is None
                         else dict(zip(ids.tolist(), slots.tolist())))

    def __len__(self) -> int:
        return len(self._slot_of)

    def find(self, ids: np.ndarray) -> np.ndarray:
        """``[k]`` int64 slots of ``ids`` (any ids, repeats allowed), -1
        where an id is not mapped."""
        return np.fromiter(map(self._slot_of.get, ids.tolist(), repeat(-1)),
                           np.int64, len(ids))

    def update(self, gone: np.ndarray, ids: np.ndarray,
               slots: np.ndarray) -> None:
        """Unmap ``gone`` (each mapped), then map ``ids[i] -> slots[i]``
        (``ids`` not mapped)."""
        slot_of = self._slot_of
        for i in gone.tolist():
            del slot_of[i]
        slot_of.update(zip(ids.tolist(), slots.tolist()))

    def sorted_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(ids, slots)`` int64, sorted by id."""
        n = len(self._slot_of)
        ids = np.fromiter(self._slot_of.keys(), np.int64, n)
        slots = np.fromiter(self._slot_of.values(), np.int64, n)
        order = np.argsort(ids)
        return ids[order], slots[order]
