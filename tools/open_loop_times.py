#!/usr/bin/env python3
"""Where a load-test request's time goes, on the port found under
``--src``, at ``chip_smoke.py`` phase 6e's serving shapes:

  python3 tools/open_loop_times.py [--src PATH] [--bundle DIR] [--qps Q ...]
                                   [--steps N ...] [--split-requests N]
                                   [--switch-interval S] [--probe-blocks N]

Writes (once, into ``--bundle``) an ensemble bundle as phase 6c deploys
it: full-width ``dlrm-criteo`` (26 tables at D 128) and ``dcn-criteo`` (26
at D 16), each vocabulary capped at ``RUN.vocab_cap`` rows (random f32
rows from a seed, the dense nets at seed-0 weights), ``RUN.cache_capacity``
L1 rows a table for each model (``cache_budget`` 2 x 131,072 split
evenly: the two models' tables are the same), one PDB. It is stood up as
one ``MultiModelServer`` over one VolatileDB. Then, in ``--steps`` order:

0. The host split of fresh traffic: the load test's warm-up
   (``launch.loadtest._warmup``), then ``loadgen.Workload``'s requests
   (Zipf 1.2 over a seeded permutation of each vocabulary, 256 rows,
   DLRM:DCN 3:1, as phase 6e sends them) through each member's
   ``predict`` one at a time: the p50 / p99 ms of each member on the
   first half; on the second half (``--split-requests`` in all) the HPS
   host stage's thread time a request by part, from line events on the
   stage's own functions (``sys.monitoring``): the L1 index search, the
   L1 index update, the L1 eviction (ageing the counters, copying them,
   ``argpartition``), the rest of the probe, the L2 query and insert (the
   insert's merge and eviction apart), the L3 fetch, the scatter's
   ``prepare``, the waits for the L1, L2 and L3 locks and, on a tree
   with the host library, each of its calls (``SPLIT_RULES``) and their
   count a request; with the events a request and what the callbacks
   cost. Also each table's L1
   residents against its capacity and each L2 namespace's rows against
   its capacity, before the warm-up, before the split and after it.
1. ``predict`` one at a time (closed loop) on the DLRM member, requests of
   ``--rows`` rows: first ``chip_smoke.make_requests``'s Zipf(1.1) rows
   (the ids its warm-up serves), the same requests again (every id
   resident in L1), then ``Workload``'s: p50 / p99 ms and the L1 hit
   rate of each;
2. the host profile (``cProfile``) of 32 more ``Workload`` requests
   through ``predict``: the functions with the most cumulative time,
   then those with the most time of their own;
3. 32 more fresh ``Workload`` requests through ``submit`` one at a time
   (closed loop) for each engine, ``stream``, ``sync``, ``stage_sync``:
   p50 / p99 ms and the L1 hit rate of each;
4. ``launch.loadtest.main`` on the ensemble bundle for each ``--qps``
   (a rate named twice runs twice), with phase 6e's settings (``chip_smoke.LOADTEST``: 256 rows,
   ``--max-coalesce 4``, Poisson, Zipf 1.2, mix 3:1, SLO 100 ms,
   ``queue_depth`` 64, a 5 s steady phase): per member the scheduled,
   delivered, shed + expired counts, p50 / p99 ms, and the largest
   submit lag. Phase 6e's steady rate is 10% of C, phase 6c's measured
   closed-loop rows/s; the default 25 requests/s is that of a C of
   64,000 rows/s.

5. one cache's probe alone: the DLRM member's first table, ``--probe-blocks``
   blocks of ``--rows`` ids (the first column of ``Workload``'s
   requests), each probed once on one thread with nothing else running
   (fresh: the misses fetched from L2 / L3) and then again (every id a
   hit): the wall us of a probe, and, on a tree with the host library,
   each of its entry points' us a call.

Each step after 0 starts from the server the previous step left.
``--switch-interval`` sets the interpreter's thread switch interval
(``sys.setswitchinterval``, 0.005 s by default) for the whole run.

Prints the card's name and power limit, the split and the profile, then
one JSON line. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import cProfile
import inspect
import io
import json
import os
import pstats
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMBERS = ("dlrm-criteo", "dcn-criteo")

#: labels of the HPS host stage: ``(module, qualified name, label of the
#: function's lines, [(regex on a line's text, label)])``, for the
#: parent's functions and this tree's. A function with rules gets line
#: events; one without, only its calls and returns. A None label, and a
#: function not listed, is charged to the caller's current label. Each
#: call into the host library (``core/hps/_host.py``, on a tree that has
#: one) is a part of its own: ``l1 pass 1`` / ``l1 pass 2`` (the probe's
#: two passes), ``l2 query: host``, ``l2 insert: host`` (an insert and,
#: past the free slots, its place), ``l3 gather``; each call's line names
#: its entry point.
SPLIT_RULES = (
    ("hps", "HPS._probe", "l1 probe other", ()),
    ("embedding_cache", "DeviceEmbeddingCache.probe", "l1 probe other",
     ((r"with self\._lock", "l1 lock wait"),)),
    ("embedding_cache", "DeviceEmbeddingCache._probe_locked",
     "l1 probe other",
     ((r"hps_l1_pass1", "l1 pass 1"),
      (r"hps_l1_pass2", "l1 pass 2"),
      (r"\*= self\.decay", "l1 evict: age"),
      (r"= self\._freq\[:n_occ\]\.copy\(\)", "l1 evict: copy"),
      (r"argpartition", "l1 evict: argpartition"),
      (r"fetch_fn\(", "fetch other"))),
    ("embedding_cache", "DeviceEmbeddingCache._evict_locked",
     "l1 evict: other",
     ((r"\*= self\.decay", "l1 evict: age"),
      (r"= self\._freq\[:n_occ\]\.copy\(\)", "l1 evict: copy"),
      (r"argpartition", "l1 evict: argpartition"))),
    ("embedding_cache", "DeviceEmbeddingCache._find_locked", "l1 search",
     ()),
    ("embedding_cache", "DeviceEmbeddingCache._update_index_locked",
     "l1 update", ()),
    ("hps", "HPS._make_fetch.<locals>.fetch", "fetch other", ()),
    ("volatile_db", "VolatileDB.query", "l2 query",
     ((r"with .*lock", "l2 lock wait"),)),
    ("volatile_db", "VolatileDB._query_locked", "l2 query", ()),
    ("volatile_db", "VolatileDB._space", None,
     ((r"with .*lock", "l2 lock wait"),)),
    ("volatile_db", "_Namespace.query", "l2 query",
     ((r"with .*lock", "l2 lock wait"),)),
    ("volatile_db", "_Shard.query_into", "l2 query: host", ()),
    ("volatile_db", "VolatileDB.insert", "l2 insert other",
     ((r"with .*lock", "l2 lock wait"),)),
    ("volatile_db", "_Namespace.insert", "l2 insert other",
     ((r"with .*lock", "l2 lock wait"),)),
    ("volatile_db", "_Shard.insert", "l2 insert other",
     ((r"hps_l2_place", "l2 insert: host"),
      (r"argpartition", "l2 insert: evict"),
      (r"np\.insert|keep|sorted_ids|sorted_slots|searchsorted|"
       r"index\.update\(", "l2 insert: merge"))),
    ("volatile_db", "_Shard._insert_sorted", "l2 insert: host", ()),
    ("volatile_db", "_Shard._lru_victims", "l2 insert: evict", ()),
    ("persistent_db", "PersistentDB.fetch", "l3 fetch",
     ((r"with self\._lock", "l3 lock wait"),
      (r"hps_gather_rows", "l3 gather"))),
    ("payload_store", "ShardedPayloadStore.prepare", "scatter prepare", ()),
)


def _code_of(obj, qualname: str):
    """The code object of ``module.qualname`` (a nested function through
    its parent's constants), or None where the tree has no such one."""
    parts = qualname.split(".")
    if "<locals>" in parts:
        i = parts.index("<locals>")
        outer = _code_of(obj, ".".join(parts[:i]))
        if outer is None:
            return None
        for c in outer.co_consts:
            if getattr(c, "co_name", None) == parts[i + 1]:
                return c
        return None
    for p in parts:
        obj = getattr(obj, p, None)
        if obj is None:
            return None
    return getattr(obj, "__code__", None)


class HostSplit:
    """Thread time of the HPS host stage by part: the time of a listed
    function's line (or of the whole function, where it has no rules), up
    to its next line event or a call of another listed function, goes to
    the line's label; so each part excludes the listed functions it
    calls. Per-thread tallies, summed by :meth:`parts`, each with the
    events that closed it, so that the callbacks' own time can be taken
    off."""

    TOOL = 1   # sys.monitoring.COVERAGE_ID: cProfile does not use it

    def __init__(self, modules):
        self._labels = {}      # code -> (default, {line: label} or None)
        for mod, qual, default, rules in SPLIT_RULES:
            code = (_code_of(modules[mod], qual) if mod in modules
                    else None)
            if code is None:
                continue
            by_line = None
            if rules:
                lines, first = inspect.getsourcelines(code)
                by_line = {}
                for k, text in enumerate(lines):
                    for pat, label in rules:
                        if re.search(pat, text):
                            by_line[first + k] = label
                            break
            self._labels[code] = (default, by_line)
        self._local = threading.local()
        self._tallies = []
        self._lock = threading.Lock()

    def _state(self):
        try:
            return self._local.st
        except AttributeError:
            st = self._local.st = ([], {})
            with self._lock:
                self._tallies.append(st)
            return st

    @staticmethod
    def _charge(frame, tally, now, cpu):
        t = tally.get(frame[1])
        if t is None:
            t = tally[frame[1]] = [0.0, 0.0, 0]
        t[0] += now - frame[2]
        t[1] += cpu - frame[3]
        t[2] += 1
        frame[2], frame[3] = now, cpu

    def _start(self, code, offset):
        now, cpu = time.perf_counter(), time.thread_time()
        stack, tally = self._state()
        if stack:
            self._charge(stack[-1], tally, now, cpu)
        label = self._labels[code][0]
        stack.append([code, label if label is not None else
                      stack[-1][1] if stack else "other", now, cpu])

    def _line(self, code, line):
        now, cpu = time.perf_counter(), time.thread_time()
        stack, tally = self._state()
        while stack and stack[-1][0] is not code:   # left by an exception
            stack.pop()
        if stack:
            self._charge(stack[-1], tally, now, cpu)
            default, by_line = self._labels[code]
            label = by_line.get(line, default)
            if label is None:
                label = stack[-2][1] if len(stack) > 1 else "other"
            stack[-1][1] = label

    def _return(self, code, offset, retval):
        now, cpu = time.perf_counter(), time.thread_time()
        stack, tally = self._state()
        while stack and stack[-1][0] is not code:
            stack.pop()
        if stack:
            self._charge(stack.pop(), tally, now, cpu)
            if stack:
                stack[-1][2], stack[-1][3] = now, cpu

    def __enter__(self):
        mon = sys.monitoring
        mon.use_tool_id(self.TOOL, "hps-host-split")
        ev = mon.events
        mon.register_callback(self.TOOL, ev.PY_START, self._start)
        mon.register_callback(self.TOOL, ev.LINE, self._line)
        mon.register_callback(self.TOOL, ev.PY_RETURN, self._return)
        for code, (_, by_line) in self._labels.items():
            mon.set_local_events(
                self.TOOL, code, ev.PY_START | ev.PY_RETURN
                | (ev.LINE if by_line is not None else 0))
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        for code in self._labels:
            mon.set_local_events(self.TOOL, code, 0)
        for e in (mon.events.PY_START, mon.events.LINE,
                  mon.events.PY_RETURN):
            mon.register_callback(self.TOOL, e, None)
        mon.free_tool_id(self.TOOL)

    def parts(self, cost=(0.0, 0.0)):
        """``({label: [wall seconds, CPU seconds]}, events)`` over every
        thread, ``cost`` (wall, CPU) seconds taken off a part for each
        event that closed it."""
        out, events = {}, 0
        with self._lock:
            for _, tally in self._tallies:
                for k, (sec, cpu, n) in tally.items():
                    o = out.setdefault(k, [0.0, 0.0])
                    o[0] += sec - n * cost[0]
                    o[1] += cpu - n * cost[1]
                    events += n
        return out, events


def _callback_cost(n: int = 2000):
    """``(wall, CPU)`` seconds an event of :class:`HostSplit` costs: a
    20-line function timed with and without its line events."""
    def body(x):
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        x += 1
        return x
    split = HostSplit({})
    split._labels[body.__code__] = ("calibration", {})
    t0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(n):
        body(0)
    bare = time.perf_counter() - t0, time.thread_time() - c0
    with split:
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(n):
            body(0)
        timed = time.perf_counter() - t0, time.thread_time() - c0
    _, events = split.parts()
    return tuple(max(0.0, a - b) / max(1, events)
                 for a, b in zip(timed, bare))


def _occupancy(servers, vdb) -> dict:
    """Each table's L1 residents against its capacity (a member's tables
    in order) and each L2 namespace's rows against its capacity."""
    l1 = {n: [[c._next_free, c.capacity] for c in s.hps.caches.values()]
          for n, s in servers.items()}
    st = vdb.stats()
    cap = st["shards"] * st["capacity_per_shard"]
    l2 = {t: [v["rows"], cap] for t, v in sorted(st["tables"].items())}
    return {"l1": l1, "l2": l2}


def _occupancy_line(occ) -> str:
    out = []
    for n, tabs in occ["l1"].items():
        full = sum(1 for r, c in tabs if r >= c)
        out.append(f"{n} L1 {sum(r for r, _ in tabs)} of "
                   f"{sum(c for _, c in tabs)} rows, {full} of {len(tabs)} "
                   f"tables full, largest table {max(r for r, _ in tabs)} of "
                   f"{max(c for _, c in tabs)}")
    l2 = list(occ["l2"].values())
    if l2:
        full = sum(1 for r, c in l2 if r >= c)
        out.append(f"L2 {sum(r for r, _ in l2)} rows in {len(l2)} "
                   f"namespaces, {full} full, largest "
                   f"{max(r for r, _ in l2)} of {l2[0][1]}")
    else:
        out.append("L2 empty")
    return "; ".join(out)


def _ensemble_bundle(cs, directory: str) -> str:
    """The ensemble bundle's ps.json, written if it is not there yet."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs.base import (EnsembleConfig,
                                          ensemble_config_to_dict)
    from repro_torch.core.hps.persistent_db import PersistentDB
    from repro_torch.models.recsys.model import RecsysModel
    from repro_torch.serve.server import write_bundle_member
    ps = os.path.join(directory, "ps.json")
    if os.path.exists(ps):
        return ps
    pdb = PersistentDB(os.path.join(directory, "pdb"))
    members = []
    for k, (arch, graph) in enumerate(zip(MEMBERS, (api.dlrm_graph,
                                                    api.dcn_graph))):
        cfg = cs.recipe_config(cs.RUN, arch, capped=True)
        params = RecsysModel(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        rng = np.random.default_rng((cs.RUN.seed, k))
        tables = {t.name: rng.standard_normal((t.vocab_size, t.dim),
                                              dtype=np.float32) * 0.1
                  for t in cfg.tables}
        members.append(write_bundle_member(
            pdb, directory, arch, graph(cfg), params, tables,
            cache_capacity=cs.RUN.cache_capacity, max_batch=cs.RUN.batch))
        del tables
    with open(ps, "w") as f:
        json.dump(ensemble_config_to_dict(EnsembleConfig(
            models=tuple(members))), f, indent=1)
    return ps


def _hit_rate(server) -> float:
    c = [x.counters() for x in server.hps.caches.values()]
    hits, miss = sum(x["hits"] for x in c), sum(x["misses"] for x in c)
    return hits / max(1, hits + miss)


def _closed_loop(server, reqs, engine=None) -> dict:
    """``reqs`` one at a time through ``predict``, or through ``submit``
    on ``engine``'s serve loop."""
    import numpy as np
    h0 = [x.counters() for x in server.hps.caches.values()]
    ms = []
    if engine is not None:
        server.engine = engine
        server.start()
    for dense, cat in reqs:
        t0 = time.perf_counter()
        if engine is None:
            server.predict(dense, cat)
        else:
            out = server.submit(dense, cat).get(timeout=300)
            if isinstance(out, BaseException):
                raise out
        ms.append(1e3 * (time.perf_counter() - t0))
    if engine is not None:
        server.stop()
    h1 = [x.counters() for x in server.hps.caches.values()]
    hits = sum(b["hits"] - a["hits"] for a, b in zip(h0, h1))
    miss = sum(b["misses"] - a["misses"] for a, b in zip(h0, h1))
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "l1_hit_rate": hits / max(1, hits + miss)}


def split_step(cs, ens, rows: int, n: int) -> dict:
    """Step 0 on the ensemble ``ens`` (a fresh MultiModelServer)."""
    import numpy as np
    from repro_torch.core.hps import (embedding_cache, hps, payload_store,
                                      persistent_db, volatile_db)
    from repro_torch.launch import loadtest
    from repro_torch.loadgen import ModelShape, Workload, WorkloadConfig
    lt = cs.LOADTEST
    servers = ens.servers
    out = {"occupancy before warm-up": _occupancy(servers, ens.vdb)}
    loadtest._warmup(servers, rows, lt.max_coalesce)
    shapes = {k: ModelShape.from_config(s.model.cfg)
              for k, s in servers.items()}
    mix = dict(zip(MEMBERS, lt.mix))
    reqs = list(Workload(WorkloadConfig(
        qps=100.0, duration_s=10 * n / 100.0, rows=rows, seed=lt.seed,
        zipf_a=lt.zipf_a, mix=mix), shapes).requests())[:n]
    half = n // 2
    ms = {k: [] for k in servers}
    for r in reqs[:half]:
        t0 = time.perf_counter()
        servers[r.model].predict(r.dense, r.cat)
        ms[r.model].append(1e3 * (time.perf_counter() - t0))
    out["predict fresh, untraced"] = {
        k: {"requests": len(v), "p50_ms": float(np.percentile(v, 50)),
            "p99_ms": float(np.percentile(v, 99))}
        for k, v in ms.items() if v}
    out["occupancy before split"] = _occupancy(servers, ens.vdb)
    c0 = {k: [c.counters() for c in s.hps.caches.values()]
          for k, s in servers.items()}
    l2_0 = ens.vdb.stats()
    split = HostSplit({"hps": hps, "embedding_cache": embedding_cache,
                       "volatile_db": volatile_db,
                       "persistent_db": persistent_db,
                       "payload_store": payload_store})
    try:
        from repro_torch.core.hps import _host
    except ImportError:     # a tree without the host library
        _host = None
    calls0 = _host.CALLS.snapshot() if _host else {}
    ms = []
    with split:
        for r in reqs[half:]:
            t0 = time.perf_counter()
            servers[r.model].predict(r.dense, r.cat)
            ms.append(1e3 * (time.perf_counter() - t0))
    m = n - half
    cost = _callback_cost()
    parts, events = split.parts(cost)
    misses = sum(b.counters()["misses"] - a["misses"]
                 for k, s in servers.items()
                 for a, b in zip(c0[k], s.hps.caches.values()))
    hits = sum(b.counters()["hits"] - a["hits"]
               for k, s in servers.items()
               for a, b in zip(c0[k], s.hps.caches.values()))
    l2_1 = ens.vdb.stats()
    calls1 = _host.CALLS.snapshot() if _host else {}
    out["split, thread ms a request (wall, CPU)"] = {
        k: [1e3 * v[0] / m, 1e3 * v[1] / m]
        for k, v in sorted(parts.items(), key=lambda kv: -kv[1][1])}
    out["split"] = {
        "requests": m, "traced predict p50_ms": float(np.percentile(ms, 50)),
        "events a request": events / m,
        "callback us an event (wall, CPU)": [1e6 * c for c in cost],
        "callbacks ms a request (taken off the parts)":
            1e3 * cost[0] * events / m,
        "l1 misses a request": misses / m, "l1 hits a request": hits / m,
        "l2 hits a request": (l2_1["hits"] - l2_0["hits"]) / m,
        "l2 misses a request": (l2_1["misses"] - l2_0["misses"]) / m,
        "host-library calls a request": {
            k: (v - calls0.get(k, 0)) / m for k, v in sorted(calls1.items())
            if v > calls0.get(k, 0)}}
    out["occupancy after split"] = _occupancy(servers, ens.vdb)
    return out


def probe_step(server, rows: int, blocks: int) -> dict:
    """Step 5 on ``server`` (the DLRM member)."""
    import numpy as np
    from repro_torch.loadgen import ModelShape, Workload, WorkloadConfig
    try:
        from repro_torch.core.hps import _host
    except ImportError:     # a tree without the host library
        _host = None
    cache = next(iter(server.hps.caches.values()))
    reqs = list(Workload(WorkloadConfig(
        qps=1000.0, duration_s=2 * blocks / 1000.0, rows=rows, seed=11,
        zipf_a=1.2), {"m": ModelShape.from_config(server.model.cfg)}
    ).requests())[:blocks]
    ids = [np.asarray(r.cat).reshape(rows, -1)[:, 0].astype(np.int64)
           for r in reqs]
    spent, calls = {}, {}
    host_call = _host.call if _host else None

    def timed_call(entry, *a, **k):
        t0 = time.perf_counter()
        try:
            return host_call(entry, *a, **k)
        finally:
            spent[entry] = spent.get(entry, 0.0) + time.perf_counter() - t0
            calls[entry] = calls.get(entry, 0) + 1

    out = {}
    for kind in ("fresh", "all hit"):
        spent.clear()
        calls.clear()
        us = []
        if _host:
            _host.call = timed_call
        try:
            for b in ids:
                t0 = time.perf_counter()
                plan = cache.probe(b)
                us.append(1e6 * (time.perf_counter() - t0))
                cache.commit(plan)
        finally:
            if _host:
                _host.call = host_call
        out[kind] = {"probes": len(us), "p50_us": float(np.percentile(us, 50)),
                     "mean_us": float(np.mean(us)),
                     "host us a call": {k: 1e6 * v / calls[k]
                                        for k, v in sorted(spent.items())},
                     "host calls a probe": {k: v / len(us)
                                            for k, v in sorted(calls.items())}}
    return out


def measure(cs, ps: str, dev, rows: int, qps_list, steps,
            split_requests: int, probe_blocks: int = 64) -> dict:
    import types
    from repro_torch.launch import loadtest
    from repro_torch.launch.serve import build_server_from_config
    from repro_torch.loadgen import ModelShape, Workload, WorkloadConfig
    out = {}
    lt = cs.LOADTEST
    ens, _ = build_server_from_config(ps, device=dev)
    try:
        if 0 in steps:
            out["step 0"] = split_step(cs, ens, rows, split_requests)
            res = out["step 0"]
            print("split (thread ms a request, wall / CPU): " + "; ".join(
                f"{k} {w:.3f} / {c:.3f}" for k, (w, c) in
                res["split, thread ms a request (wall, CPU)"].items()))
            print("split: " + json.dumps(res["split"]))
            for k in ("occupancy before warm-up", "occupancy before split",
                      "occupancy after split"):
                print(f"{k}: {_occupancy_line(res[k])}")
        server = ens.servers[MEMBERS[0]]
        cfg = server.model.cfg
        run = types.SimpleNamespace(**{**vars(cs.RUN), "batch": rows})
        wl = [(r.dense, r.cat) for r in Workload(
            WorkloadConfig(qps=1000.0, duration_s=0.3, rows=rows, seed=7,
                           zipf_a=1.2),
            {"m": ModelShape.from_config(cfg)}).requests()]
        if 1 in steps:
            warm = cs.make_requests(run, cfg, cs.RUN.warmup, 1)
            syn = cs.make_requests(run, cfg, 64, 2)
            for d, c in warm:
                server.predict(d, c)
            out["predict zipf 1.1 (warm ids)"] = _closed_loop(server, syn)
            out["predict L1-resident (the same 64 again)"] = _closed_loop(
                server, syn)
            out["predict workload, first 64"] = _closed_loop(server,
                                                             wl[:64])
            out["predict workload, next 64"] = _closed_loop(server,
                                                            wl[64:128])
        if 2 in steps:
            prof = cProfile.Profile()
            prof.enable()
            _closed_loop(server, wl[128:160])
            prof.disable()
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats("cumulative") \
                .print_stats(25)
            pstats.Stats(prof, stream=buf).sort_stats("tottime") \
                .print_stats(25)
            print(buf.getvalue())
        if 3 in steps:
            for i, engine in enumerate(("stream", "sync", "stage_sync")):
                out[f"submit {engine}, fresh 32"] = _closed_loop(
                    server, wl[160 + 32 * i:192 + 32 * i], engine)
        if 5 in steps:
            out["step 5"] = probe_step(server, rows, probe_blocks)
            print("probe alone: " + json.dumps(out["step 5"]))
    finally:
        ens.close()
    if 4 not in steps:
        return out
    for run, qps in enumerate(qps_list):
        with tempfile.TemporaryDirectory() as d:
            res = loadtest.main([
                "--config", ps, "--device", dev.type, "--rows", str(rows),
                "--max-coalesce", str(lt.max_coalesce), "--arrival",
                "poisson", "--qps", repr(qps), "--duration",
                str(lt.steady_s), "--seed", str(lt.seed), "--zipf-a",
                str(lt.zipf_a), "--slo-ms", str(lt.slo_ms), "--queue-depth",
                str(lt.queue_depth), "--drift-per-s", "0", "--mix",
                ",".join(f"{n}={w}" for n, w in zip(MEMBERS, lt.mix)),
                "--artifacts", os.path.join(d, "a.json")])
        st = res["phases"]["steady"]
        key = f"open loop {qps} qps, run {run}"
        out[key] = {
            n: {"scheduled": m["scheduled"], "delivered": m["delivered"],
                "shed_or_expired": st["server"][n]["requests_shed"]
                + st["server"][n]["requests_expired"],
                "p50_ms": m["latency_ms"]["p50"],
                "p99_ms": m["latency_ms"]["p99"]}
            for n, m in st["client"]["models"].items()}
        out[key]["max_submit_lag_ms"] = st["client"]["max_submit_lag_ms"]
        print(f"{key}: " + json.dumps(out[key]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--bundle",
                    default=os.path.join(ROOT, ".archive",
                                         "open_loop_bundle"))
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--steps", type=int, nargs="*",
                    default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--split-requests", type=int, default=160)
    ap.add_argument("--switch-interval", type=float, default=None,
                    help="sys.setswitchinterval for the run (seconds)")
    ap.add_argument("--qps", type=float, nargs="*", default=[25.0])
    ap.add_argument("--probe-blocks", type=int, default=64)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("open_loop_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    ps = _ensemble_bundle(cs, args.bundle)
    print(f"bundle: {time.perf_counter() - t0:.1f} s")
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    out = measure(cs, ps, torch.device("cuda", 0), args.rows, args.qps,
                  args.steps, args.split_requests, args.probe_blocks)
    print(json.dumps({"src": args.src, "rows": args.rows,
                      "switch_interval_s": sys.getswitchinterval(),
                      "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
