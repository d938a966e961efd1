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
servers bit for bit. The command line (``main``) is ROADMAP queue 1
item 6.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.api import Model
from repro_torch.configs.base import (
    EnsembleConfig, HPSConfig, ps_config_from_dict, recsys_config_hash,
)
from repro_torch.convert import check_dense, dense_from_flat
from repro_torch.core.hps.message_bus import MessageBus
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.core.hps.volatile_db import VolatileDB
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
                        payload_dtype: Optional[str] = None
                        ) -> Tuple[InferenceServer, Model]:
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
    return build_server(model, pdb, hcfg, dense, vdb=vdb, bus=bus), graph


def build_server_from_config(
        ps_path: str, *, device: DeviceLike = None,
        vdb: Optional[VolatileDB] = None,
        bus: Optional[MessageBus] = None,
        cache_capacity: Union[int, Dict[str, int], None] = None,
        payload_dtype: Optional[str] = None,
        cache_budget: Optional[int] = None,
        rebalance_interval_s: Optional[float] = None):
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
    a single-model bundle ignores them.
    """
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
                                   payload_dtype=payload_dtype)

    pdb = PersistentDB(os.path.join(base, cfg.models[0].pdb_root))
    vdb = vdb if vdb is not None else VolatileDB()    # shared L2
    bus = bus if bus is not None else MessageBus()    # shared bus
    servers, models = {}, {}
    for hcfg in cfg.models:
        servers[hcfg.model], models[hcfg.model] = _build_model_server(
            base, hcfg, pdb, device=dev, vdb=vdb, bus=bus,
            cache_capacity=cap(hcfg.model), payload_dtype=payload_dtype)
    return MultiModelServer(servers, vdb=vdb, pdb=pdb, bus=bus,
                            cache_budget=cache_budget,
                            rebalance_interval_s=rebalance_interval_s), \
        models
