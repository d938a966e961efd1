"""Config-driven serving launcher (paper Figure 2, the ps.json path),
counterpart of ``repro/launch/serve.py`` for single-model bundles.

A bundle — ``ps.json`` + ``graph.json`` + ``dense.npz`` + the ``pdb/``
table files, written by either package — is all this needs.
:func:`build_server_from_config` re-lowers the graph (config hash
verified), reloads the dense weights, reopens the PDB tables and stands
up the ``HPS`` + ``InferenceServer`` on the requested device (``cuda``
unless told otherwise). Ensemble bundles come with ``MultiModelServer``
(ROADMAP item "The rest of the serving engine").
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from repro_torch.api import Model
from repro_torch.configs.base import (
    HPSConfig, ps_config_from_dict, recsys_config_hash,
)
from repro_torch.convert import check_dense, dense_from_flat
from repro_torch.core.hps.hps import HPS
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys.model import RecsysModel
from repro_torch.serve.server import InferenceServer


def load_ps_config(path: str) -> HPSConfig:
    with open(path) as f:
        return ps_config_from_dict(json.load(f))


def build_server_from_config(ps_path: str, *, device: DeviceLike = None,
                             cache_capacity: Optional[int] = None,
                             payload_dtype: Optional[str] = None
                             ) -> Tuple[InferenceServer, Model]:
    """ps.json -> ``(InferenceServer, api.Model)`` on ``device``.

    ``cache_capacity`` and ``payload_dtype`` override the bundle's L1
    rows per table and storage precision (the PDB rows stay f32).
    """
    dev = resolve_device(device)
    base = os.path.dirname(os.path.abspath(ps_path))
    hcfg = load_ps_config(ps_path)
    if cache_capacity is not None:
        hcfg = dataclasses.replace(hcfg, cache_capacity=cache_capacity)
    if payload_dtype is not None:
        hcfg = dataclasses.replace(hcfg, payload_dtype=payload_dtype)
    if hcfg.wide:
        raise NotImplementedError(
            "wide bundles (wdl/deepfm) are the ROADMAP item 'The other "
            "recipes and graphs'")
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
                                device=dev)
    check_dense(cfg, dense)
    pdb = PersistentDB(os.path.join(base, hcfg.pdb_root))
    for t in hcfg.tables:
        pdb.open_table(hcfg.model, t.name)
    hps = HPS(hcfg.model, cfg.tables, pdb,
              cache_capacity=hcfg.cache_capacity,
              cache_shards=hcfg.cache_shards,
              payload_dtype=hcfg.payload_dtype, device=dev)
    model = RecsysModel(cfg, device=dev,
                        global_batch=graph.solver.batch_size)
    server = InferenceServer(model, dense, hps, max_batch=hcfg.max_batch)
    return server, graph
