"""The exact id -> slot map behind the HPS host indexes (the L1 cache's
and each L2 shard's).

The reference keeps each index as a sorted id array with its slots, and
merges every change into it: a pass over all the residents on every
call that inserts. Here the map is a hash table in the host library
(``_host``: open addressing, deletion by backward shift), so a search or
an update costs time in the ids of the call, not in the residents. Any exact map answers every
search the same way, so the callers' slot decisions (made from their own
LFU counters or LRU ticks) are the reference's.
:meth:`IdIndex.sorted_view` gives the reference's sorted ``(ids, slots)``
arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.hps import _host


class IdIndex:
    """Unique int ids -> int slots (>= 0). Not thread-safe: the owner's
    lock guards it. ``handle`` is the map the host passes take."""

    __slots__ = ("_map",)

    def __init__(self, ids: Optional[np.ndarray] = None,
                 slots: Optional[np.ndarray] = None):
        """The map of ``ids[i] -> slots[i]`` (empty when None)."""
        self._map = (_host.HostMap(np.empty(0, np.int64),
                                   np.empty(0, np.int64))
                     if ids is None else _host.HostMap(ids, slots))

    @property
    def handle(self) -> int:
        return self._map.handle

    def __len__(self) -> int:
        return _host.call("hps_map_size", self._map.handle)

    def find(self, ids: np.ndarray) -> np.ndarray:
        """``[k]`` int64 slots of ``ids`` (any ids, repeats allowed), -1
        where an id is not mapped."""
        ids = _host.i64(ids)
        out = np.empty(len(ids), np.int64)
        if len(ids):
            _host.call("hps_map_find", self._map.handle, _host.ptr(ids),
                       len(ids), _host.ptr(out))
        return out

    def update(self, gone: np.ndarray, ids: np.ndarray,
               slots: np.ndarray) -> None:
        """Unmap ``gone`` (each mapped), then map ``ids[i] -> slots[i]``
        (``ids`` not mapped)."""
        gone, ids, slots = _host.i64(gone), _host.i64(ids), _host.i64(slots)
        if len(ids) != len(slots):
            raise ValueError(f"{len(ids)} ids for {len(slots)} slots")
        rc = _host.call("hps_map_update", self._map.handle, _host.ptr(gone),
                        len(gone), _host.ptr(ids), _host.ptr(slots),
                        len(ids))
        if rc > 0:
            raise KeyError(int(gone[rc - 1]))
        _host.check("hps_map_update", rc)

    def sorted_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(ids, slots)`` int64, sorted by id."""
        n = len(self)
        ids = np.empty(n, np.int64)
        slots = np.empty(n, np.int64)
        if n:
            _host.call("hps_map_dump", self._map.handle, _host.ptr(ids),
                       _host.ptr(slots))
        order = np.argsort(ids)
        return ids[order], slots[order]
