"""Config-driven serving launcher (paper Figure 2, the ps.json path),
counterpart of ``repro/launch/serve.py``.

A bundle, ``ps.json`` + ``graph.json`` + ``dense.npz`` + the ``pdb/``
table files, written by either package, is all this needs.
:func:`build_server_from_config` re-lowers the graph (config hash
verified), reloads the dense weights, reopens the PDB tables and stands
up the ``HPS`` + ``InferenceServer`` on the requested device (``cuda``
unless told otherwise); a wide bundle (WDL, DeepFM, a graph with a wide
branch: ``"wide": true``) gets a second ``HPS`` over the ``*_wide`` twins
and an N-group graph one ``HPS`` per extra group (its tables come from the
lowered config, as the reference's), all on the one PDB, with the bundle's
L1 capacity, striping and payload type over the caller's VolatileDB and
message bus, and the server drains the bundle's refresh budget a tick.

An ENSEMBLE bundle (``repro-ps-ensemble-v1``, written by
``api.deploy_ensemble`` of either package) holds several models behind
one ps.json; the same entry point then stands up a ``MultiModelServer``:
per-model L1 caches and serve loops over ONE PersistentDB, ONE
VolatileDB and ONE message bus, its predictions those of per-model
servers bit for bit.

The command line (``main``) is the reference's, with ``--device``:

  # serve an existing bundle (single-model or ensemble), on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --config /path/ps.json \\
      --requests 50 --batch 64

  # demo on the CPU: train a smoke recipe a few steps, deploy, then serve
  # THROUGH the written bundle (wdl exercises the two-HPS wide path)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-criteo \\
      --requests 50 --batch 64 --device cpu

  # demo: 2-model ensemble bundle, one storage backend, per-model stats
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch dlrm-criteo,dcn-criteo --requests 10 --batch 32 --device cpu

``--sanitize`` arms the hot-path twin (``repro_torch.analysis.
HotPathMonitor``) over the measured phase and fails unless the serve
loops made exactly one host sync a served group and no fresh load of the
kernel library (the twin's ``compiles``); ``--payload-dtype f16|int8``
also holds one batch a model against an f32 rebuild of the same bundle.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import tempfile
import time
from contextlib import nullcontext
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.api import Model, Solver, deploy_ensemble
from repro_torch.configs.base import (
    EnsembleConfig, HPSConfig, ps_config_from_dict, recsys_config_hash,
)
from repro_torch.configs.registry import RECSYS_RECIPES
from repro_torch.convert import check_dense, dense_from_flat
from repro_torch.core.hps.message_bus import MessageBus
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.core.hps.volatile_db import VolatileDB
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys.model import RecsysModel, wide_tables
from repro_torch.serve.server import (InferenceServer, MultiModelServer,
                                      build_server)


def load_ps_config(path: str) -> Union[HPSConfig, EnsembleConfig]:
    """ps.json -> :class:`HPSConfig` or :class:`EnsembleConfig`."""
    with open(path) as f:
        return ps_config_from_dict(json.load(f))


def _build_model_server(base: str, hcfg: HPSConfig, pdb: PersistentDB, *,
                        device, vdb: Optional[VolatileDB],
                        bus: Optional[MessageBus],
                        cache_capacity: Optional[int] = None,
                        payload_dtype: Optional[str] = None,
                        cache_mesh=None) -> Tuple[InferenceServer, Model]:
    """One model's HPSes + InferenceServer over an open PDB: reload the
    graph and the dense weights from the bundle, then hand off to
    ``serve.server.build_server``, the wiring the in-process deploy uses."""
    if cache_capacity is not None:      # operator override of the
        hcfg = dataclasses.replace(     # bundle's (hotness-sized) L1
            hcfg, cache_capacity=cache_capacity)
    if payload_dtype is not None:       # the PDB / VDB rows stay f32
        hcfg = dataclasses.replace(hcfg, payload_dtype=payload_dtype)
    graph = Model.from_json(os.path.join(base, hcfg.graph_path))
    cfg = graph.to_recsys_config()
    if hcfg.config_hash and recsys_config_hash(cfg) != hcfg.config_hash:
        raise ValueError(f"model {hcfg.model!r}: graph does not lower "
                         "to the deployed config (hash mismatch)")
    if graph.name != hcfg.model:
        raise ValueError(f"{hcfg.graph_path}: graph name {graph.name!r} != "
                         f"deployed model name {hcfg.model!r}")

    with np.load(os.path.join(base, hcfg.dense_weights_path)) as data:
        dense = dense_from_flat({k: data[k] for k in data.files},
                                device=device)
    check_dense(cfg, dense)
    model = RecsysModel(cfg, device=device,
                        global_batch=graph.solver.batch_size)

    # every table set opens before any HPS is built: each HPS's consumer
    # writes every table of the model to the PDB, as the reference's
    sets = [cfg.tables] + ([wide_tables(cfg)] if hcfg.wide else []) \
        + [g.tables for g in cfg.extra_groups]
    for tables in sets:
        for t in tables:
            pdb.open_table(hcfg.model, t.name)
    return build_server(model, pdb, hcfg, dense, vdb=vdb, bus=bus,
                        cache_mesh=cache_mesh), graph


def build_server_from_config(
        ps_path: str, *, device: DeviceLike = None,
        vdb: Optional[VolatileDB] = None,
        bus: Optional[MessageBus] = None,
        cache_capacity: Union[int, Dict[str, int], None] = None,
        payload_dtype: Optional[str] = None,
        cache_budget: Optional[int] = None,
        rebalance_interval_s: Optional[float] = None, cache_mesh=None):
    """ps.json -> a ready server on ``device``.

    A single-model bundle gives ``(InferenceServer, api.Model)``, an
    ensemble bundle ``(MultiModelServer, {name: api.Model})``: every
    member served from one PersistentDB, one VolatileDB and one message
    bus (made here when ``vdb`` / ``bus`` are None). A single model's
    HPSes share ``vdb`` (each makes its own if None, as the reference's)
    and apply ``bus``'s updates (none if None).

    ``cache_capacity`` overrides the bundle's L1 rows per table: an
    ``int`` for every model, or a ``{model: rows}`` dict that pins some
    members and leaves the rest on their bundled value.
    ``payload_dtype`` overrides the L1 storage precision of every member
    (the PDB rows stay f32). ``cache_budget`` and
    ``rebalance_interval_s`` arm the ensemble's observed-miss budget
    rebalancer (see :class:`~repro_torch.serve.server.MultiModelServer`);
    a single-model bundle ignores them. ``cache_mesh``
    (``launch.mesh.make_cache_mesh``) lays every L1's ``cache_shards``
    stripes out across its devices; a mesh of more than one device serves
    on its first unless ``device`` is given.
    """
    if device is None and cache_mesh is not None and len(cache_mesh) > 1:
        device = cache_mesh[0]
    dev = resolve_device(device)
    base = os.path.dirname(os.path.abspath(ps_path))
    cfg = load_ps_config(ps_path)

    def cap(model_name):
        if isinstance(cache_capacity, dict):
            return cache_capacity.get(model_name)
        return cache_capacity

    if isinstance(cfg, HPSConfig):
        pdb = PersistentDB(os.path.join(base, cfg.pdb_root))
        return _build_model_server(base, cfg, pdb, device=dev, vdb=vdb,
                                   bus=bus, cache_capacity=cap(cfg.model),
                                   payload_dtype=payload_dtype,
                                   cache_mesh=cache_mesh)

    pdb = PersistentDB(os.path.join(base, cfg.models[0].pdb_root))
    vdb = vdb if vdb is not None else VolatileDB()    # shared L2
    bus = bus if bus is not None else MessageBus()    # shared bus
    servers, models = {}, {}
    for hcfg in cfg.models:
        servers[hcfg.model], models[hcfg.model] = _build_model_server(
            base, hcfg, pdb, device=dev, vdb=vdb, bus=bus,
            cache_capacity=cap(hcfg.model), payload_dtype=payload_dtype,
            cache_mesh=cache_mesh)
    return MultiModelServer(servers, vdb=vdb, pdb=pdb, bus=bus,
                            cache_budget=cache_budget,
                            rebalance_interval_s=rebalance_interval_s), \
        models


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def _train_model(arch: str, train_steps: int, batch: int,
                 device: DeviceLike = None) -> Model:
    """Train one recipe's smoke model briefly through the graph API
    (novel graph archs included) on ``device``."""
    mod = importlib.import_module(RECSYS_RECIPES[arch])
    m = mod.build_model(smoke=True,
                        solver=Solver(batch_size=batch, lr=1e-2))
    m.compile(device=device)
    hist = m.fit(steps=train_steps)
    print(f"[{m.name}] trained {train_steps} steps, "
          f"loss={hist[-1]['loss']:.4f}")
    return m


def _train_and_deploy(archs: Sequence[str], train_steps: int, batch: int,
                      deploy_dir: str, cache_capacity: Optional[int],
                      payload_dtype: str = "f32",
                      device: DeviceLike = None) -> str:
    """Demo path: train the recipes briefly, write ONE deployment bundle
    (single-model or ensemble), return the ps.json path.
    ``cache_capacity=None`` lets ensembles size per-model L1 caches from
    table hotness; ``payload_dtype`` persists in the bundle's ps.json, so
    the rebuilt server serves the same precision mode."""
    models = [_train_model(a, train_steps, batch, device) for a in archs]
    if len(models) == 1:
        served = models[0].deploy(deploy_dir,
                                  cache_capacity=cache_capacity or 2048,
                                  payload_dtype=payload_dtype)
    else:
        served = deploy_ensemble(models, deploy_dir,
                                 cache_capacity=cache_capacity,
                                 payload_dtype=payload_dtype)
    served.close()                      # the bundle is what is served
    return os.path.join(deploy_dir, "ps.json")


def _members(built, loaded) -> Tuple[Dict, Dict]:
    """``({name: InferenceServer}, {name: api.Model})`` of a rebuilt
    single-model or ensemble server."""
    if isinstance(built, MultiModelServer):
        return {name: built[name] for name in built.models}, dict(loaded)
    return {loaded.name: built}, {loaded.name: loaded}


def _serve_bundle(ps_path: str, requests: int, batch: int, *,
                  sanitize: bool = False,
                  payload_dtype: Optional[str] = None,
                  device: DeviceLike = None) -> Dict:
    """Stand the bundle back up on ``device``, push requests through
    ``submit`` and print the serving picture (per model for ensembles);
    returns it.

    ``sanitize=True`` arms the hot-path twin over the measured phase and
    fails the run unless the serve loops performed exactly ONE host sync
    per delivered group and ZERO fresh loads of the kernel library — the
    pipeline invariants. ``payload_dtype`` overrides the bundle's L1
    storage precision."""
    built, loaded = build_server_from_config(ps_path, device=device,
                                             payload_dtype=payload_dtype)
    servers, _ = _members(built, loaded)
    data = {n: SyntheticCTR(s.model.cfg, batch) for n, s in servers.items()}
    outs = {n: [] for n in servers}
    report: Dict = {"models": {}}
    try:
        for n, s in servers.items():          # warm off the clock
            warm = data[n].batch(10_000)
            s.predict(warm["dense"], warm["cat"])
            if sanitize:
                # pin one request per coalesced group so "one sync per
                # group" is countable against the delivered groups
                s.max_batch = batch
            s.start()
        if sanitize:                          # warm the serve-loop path
            for r in range(2):
                warm_handles = [
                    s.submit(req["dense"], req["cat"])
                    for n, s in servers.items()
                    for req in (data[n].batch(30_000 + r),)]
                for h in warm_handles:
                    h.get(timeout=300)
        for s in servers.values():
            s.reset_latencies()

        if sanitize:
            from repro_torch.analysis import HotPathMonitor
            mon = HotPathMonitor("serve-smoke")
        else:
            mon = None
        t0 = time.time()
        with mon if mon is not None else nullcontext():
            handles = []
            for r in range(requests):
                for n, s in servers.items():
                    req = data[n].batch(20_000 + r)
                    handles.append((n, s.submit(req["dense"],
                                                req["cat"])))
            for n, h in handles:
                out = h.get(timeout=300)
                if isinstance(out, Exception):  # a failed group delivers
                    raise out                   # its exception — surface
                outs[n].append(out)
        dt = time.time() - t0
        for s in servers.values():
            s.stop()

        if mon is not None:
            groups = sum(s.counters()["groups_served"]
                         for s in servers.values())
            summ = mon.summary()
            if summ["syncs"] != groups or summ["compiles"] != 0:
                raise SystemExit(
                    f"hot-path sanitizer: expected {groups} host syncs "
                    f"(one per served group) and 0 kernel-library loads; "
                    f"observed {summ['syncs']} syncs ({summ['d2h']} d2h, "
                    f"{summ['block']} block) and {summ['compiles']} "
                    "load(s)")
            print(f"sanitizer: {summ['syncs']} host syncs over {groups} "
                  "served groups, 0 fresh kernel-library loads")
            report["sanitizer"] = {**summ, "groups": groups}

        total = sum(len(o) for os_ in outs.values() for o in os_)
        print(f"served {total} predictions over {len(servers)} model(s) "
              f"in {dt:.2f}s ({total / dt:.0f} qps)")
        report.update(predictions=total, seconds=dt)
        for n, s in servers.items():
            # one full prediction batch per model from the rebuilt
            # server, or the bundle round-trip is broken: an explicit
            # raise (asserts vanish under python -O)
            if not outs[n] or any(len(o) != batch for o in outs[n]):
                raise SystemExit(
                    f"model {n!r}: expected {requests} responses of "
                    f"{batch} rows, got {[len(o) for o in outs[n]]}")
            pct = s.latency_percentiles()
            stats = s.hps.stats()
            hit = np.mean(list(stats["l1_hit_rate"].values()))
            print(f"[{n}] {len(outs[n])} responses; latency ms: "
                  f"p50={pct['p50']:.1f} p95={pct['p95']:.1f} "
                  f"p99={pct['p99']:.1f}; L1 hit rate {hit:.3f}; "
                  f"L2 hits={stats['l2_hits']} "
                  f"misses={stats['l2_misses']}; L3 fetches="
                  f"{sum(stats['l3_fetches']['calls'].values())}")
            report["models"][n] = {"responses": len(outs[n]),
                                   "latency_ms": pct,
                                   "l1_hit_rate": float(hit)}

        report["payload_dev"] = _crosscheck_compressed(
            ps_path, servers, data, override=payload_dtype, device=device)
    finally:
        built.close()
    return report


#: max-abs prediction deviation a compressed bundle may show against an
#: f32-reference rebuild of the same bundle (post-sigmoid outputs)
_PAYLOAD_TOL = {"f16": 0.05, "int8": 0.1}


def _crosscheck_compressed(ps_path: str, servers, data, *,
                           override: Optional[str] = None,
                           device: DeviceLike = None) -> Dict[str, float]:
    """Compressed-payload bundles: rebuild an f32-reference server from
    the SAME bundle (the dtype override re-pulls full-precision rows from
    the shared PDB) and require one prediction batch per compressed model
    to stay within quantization tolerance. Runs after the measured phase,
    so its extra syncs never trip the sanitizer. Returns each compressed
    model's max-abs deviation."""
    cfg = load_ps_config(ps_path)
    members = cfg.models if isinstance(cfg, EnsembleConfig) else (cfg,)
    dtypes = {m.model: override or m.payload_dtype for m in members}
    if all(dt == "f32" for dt in dtypes.values()):
        return {}
    ref_built, _ = build_server_from_config(ps_path, device=device,
                                            payload_dtype="f32")
    if isinstance(ref_built, MultiModelServer):
        refs = {name: ref_built[name] for name in ref_built.models}
    else:
        refs = {next(iter(servers)): ref_built}
    devs = {}
    try:
        for n, s in servers.items():
            if dtypes[n] == "f32":
                continue
            req = data[n].batch(77_000)
            got = s.predict(req["dense"], req["cat"])
            want = refs[n].predict(req["dense"], req["cat"])
            dev = float(np.abs(got - want).max())
            tol = _PAYLOAD_TOL[dtypes[n]]
            if dev > tol:       # explicit raise: asserts vanish under -O
                raise SystemExit(
                    f"model {n!r}: {dtypes[n]} payload predictions "
                    f"deviate {dev:.4f} from the f32 reference "
                    f"(tolerance {tol})")
            print(f"[{n}] {dtypes[n]} payload within {tol} of the f32 "
                  f"reference rebuild (max abs dev {dev:.5f})")
            devs[n] = dev
    finally:
        ref_built.close()
    return devs


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Serve a bundle (or train, deploy and serve one); returns the
    serving picture :func:`_serve_bundle` printed."""
    ap = argparse.ArgumentParser(
        description="Serve a deployment bundle through submit()")
    ap.add_argument("--config", default=None,
                    help="ps.json of an existing deployment bundle")
    ap.add_argument("--arch", default="dlrm-criteo",
                    help="demo mode: train+deploy these recipes first "
                         "(comma-separated list of "
                         f"{'|'.join(sorted(RECSYS_RECIPES))}; 2+ archs "
                         "deploy an ensemble bundle; twotower/crossdeep "
                         "are novel graphs served via the generic "
                         "compiler)")
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--cache-capacity", type=int, default=None,
                    help="per-model L1 rows (default: 2048 for a single "
                         "model; hotness-proportional for ensembles)")
    ap.add_argument("--payload-dtype", default=None,
                    choices=("f32", "f16", "int8"),
                    help="L1 payload storage precision: baked into the "
                         "bundle in demo mode, or an override when "
                         "serving an existing --config bundle; non-f32 "
                         "modes additionally cross-check one prediction "
                         "per model against an f32-reference rebuild")
    ap.add_argument("--deploy-dir", default=None)
    ap.add_argument("--sanitize", action="store_true",
                    help="arm the hot-path twin over the measured phase: "
                         "fail unless every served group cost exactly "
                         "one host sync and no fresh kernel-library load")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ps_path = args.config
    if ps_path is None:
        archs = [a.strip() for a in args.arch.split(",") if a.strip()]
        known = tuple(sorted(RECSYS_RECIPES))
        bad = [a for a in archs if a not in known]
        if bad:
            ap.error(f"unknown arch(es) {bad}; choose from {known}")
        deploy_dir = args.deploy_dir or tempfile.mkdtemp(prefix="hps_")
        ps_path = _train_and_deploy(archs, args.train_steps, args.batch,
                                    deploy_dir, args.cache_capacity,
                                    payload_dtype=args.payload_dtype
                                    or "f32", device=args.device)
        print(f"deployment bundle: {deploy_dir}")
        payload_override = None          # the bundle already carries it
    else:
        payload_override = args.payload_dtype

    return _serve_bundle(ps_path, args.requests, args.batch,
                         sanitize=args.sanitize,
                         payload_dtype=payload_override, device=args.device)


if __name__ == "__main__":
    main()
