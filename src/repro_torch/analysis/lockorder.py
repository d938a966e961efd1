"""Dynamic lock-order recorder — test-only instrumentation (a copy of
``repro/analysis/lockorder.py``, stdlib only).

The static pass (``concurrency.py`` LOCK003) proves acyclicity of the
acquisition edges it can SEE; this module proves it for the edges that
actually HAPPEN. :class:`LockOrderRecorder` wraps live ``Lock``/
``RLock`` instances with :class:`_RecordingLock`, which forwards
``acquire``/``release`` (and the context-manager protocol) to the real
lock while maintaining a per-thread stack of held locks. Acquiring
lock B while holding lock A records the edge ``A -> B``; after a
concurrency hammer, ``assert_acyclic()`` fails with the offending
cycle if any two threads ever ordered the same pair of locks both
ways. Reentrant re-acquisition of a lock already on the thread's stack
records no edges (that is what RLocks are for).

Usage (see ``tests/test_torch_serving_engine.py``)::

    rec = LockOrderRecorder()
    rec.instrument_hps(hps)        # wraps cache/VDB/PDB/bus locks
    ... run the refresh/stream/update hammer ...
    assert rec.edges()             # the hammer really contended
    rec.assert_acyclic()

Instrumentation is per-instance (``setattr`` of the lock attribute),
so production code paths are untouched unless a test opts in.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class _RecordingLock:
    """Wraps a ``Lock``/``RLock``, reporting acquisitions to the
    recorder. Supports the subset of the lock API the repo uses:
    ``acquire``/``release`` and ``with``."""

    def __init__(self, inner, name: str, rec: "LockOrderRecorder"):
        self._inner = inner
        self._name = name
        self._rec = rec

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._rec._on_acquire(self._name)
        return got

    def release(self) -> None:
        self._rec._on_release(self._name)
        self._inner.release()

    def __enter__(self) -> "_RecordingLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class LockOrderRecorder:

    _GUARDED_BY = {"_edges": "_mu"}

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], int] = {}
        self._local = threading.local()

    # -- instrumentation -----------------------------------------------------

    def wrap(self, obj, attr: str = "_lock",
             name: Optional[str] = None) -> _RecordingLock:
        """Replace ``obj.<attr>`` with a recording wrapper (idempotent:
        an already-wrapped lock is returned as-is, so shared storage in
        ensembles is wrapped once)."""
        inner = getattr(obj, attr)
        if isinstance(inner, _RecordingLock):
            return inner
        rl = _RecordingLock(
            inner, name or f"{type(obj).__name__}.{attr}", self)
        setattr(obj, attr, rl)
        return rl

    def instrument_hps(self, hps, tag: str = "") -> None:
        """Wrap every lock an ``HPS`` stack can contend on: per-table
        L1 cache locks, the shared VDB/PDB locks and the VDB's namespace
        locks, the L3 stats lock, the host-pool lock, and the message-bus
        lock (when wired)."""
        p = f"{tag}:" if tag else ""
        for tname, cache in hps.caches.items():
            self.wrap(cache, "_lock", f"{p}cache[{tname}]._lock")
        self.wrap(hps.vdb, "_lock", f"{p}VolatileDB._lock")
        self._wrap_spaces(hps.vdb, p)
        self.wrap(hps.pdb, "_lock", f"{p}PersistentDB._lock")
        self.wrap(hps, "_l3_stats_lock", f"{p}HPS._l3_stats_lock")
        self.wrap(hps, "_pool_lock", f"{p}HPS._pool_lock")
        if hps.consumer is not None:
            self.wrap(hps.consumer.bus, "_lock", f"{p}MessageBus._lock")

    def _wrap_spaces(self, vdb, p: str) -> None:
        """Wrap the lock of each of ``vdb``'s namespaces (one a table),
        those it makes later included (idempotent)."""
        make = vdb._space
        if getattr(make, "recorded", False):
            return

        def space(table: str):
            ns = make(table)
            self.wrap(ns, "_lock", f"{p}VolatileDB[{table}]._lock")
            return ns
        space.recorded = True
        vdb._space = space
        for table in list(vdb._spaces):
            space(table)

    # -- recording (called with the wrapped lock just taken) -----------------

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _on_acquire(self, name: str) -> None:
        st = self._stack()
        if name not in st:      # reentrant re-acquire: no new edges
            held = list(dict.fromkeys(st))
            if held:
                with self._mu:
                    for h in held:
                        self._edges[(h, name)] = \
                            self._edges.get((h, name), 0) + 1
        st.append(name)

    def _on_release(self, name: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    # -- inspection ----------------------------------------------------------

    def edges(self) -> Set[Tuple[str, str]]:
        with self._mu:
            return set(self._edges)

    def edge_counts(self) -> Dict[Tuple[str, str], int]:
        with self._mu:
            return dict(self._edges)

    def find_cycle(self) -> Optional[List[str]]:
        graph: Dict[str, Set[str]] = {}
        for a, b in self.edges():
            graph.setdefault(a, set()).add(b)

        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}

        def dfs(n: str, stack: List[str]) -> Optional[List[str]]:
            color[n] = GREY
            stack.append(n)
            for m in sorted(graph.get(n, ())):
                if color.get(m, WHITE) == GREY:
                    return stack[stack.index(m):] + [m]
                if color.get(m, WHITE) == WHITE:
                    color.setdefault(m, WHITE)
                    cyc = dfs(m, stack)
                    if cyc:
                        return cyc
            stack.pop()
            color[n] = BLACK
            return None

        for n in sorted(graph):
            if color[n] == WHITE:
                cyc = dfs(n, [])
                if cyc:
                    return cyc
        return None

    def assert_acyclic(self) -> None:
        cyc = self.find_cycle()
        if cyc is not None:
            raise AssertionError(
                "lock-order cycle observed at runtime: "
                + " -> ".join(cyc))
