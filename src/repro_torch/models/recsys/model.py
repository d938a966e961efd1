"""``RecsysModel`` (counterpart of ``repro/models/recsys/model.py``): the
paper's four recipes, DLRM, DCN, DeepFM and Wide&Deep, and any
``model="graph"`` config. The sparse half is the primary embedding
collection (param key ``embedding``); for WDL, DeepFM and a graph with
``wide_branch``, a second collection of the tables' dim-1 "wide" twins
(``wide_embedding``, every twin ``data_parallel``, reading the primary
``cat`` columns); and for an N-group graph one collection per extra group
(``embedding@<group>``), each reading its own ``cat`` columns. The dense
half is the compiled dense program: the recipe's layers under their
historical names (``bottom``/``top``; ``cross``/``deep``/``combine``;
``deep``/``dense_w``/``bias``), or a graph's layers keyed by their output
tensor.

``apply(params, batch)`` returns logits ``[B]``; ``loss_fn`` adds BCE.
batch = {"dense": [B, Nd] f32, "cat": [B, T, H] int32 (-1 pad), "label": [B]};
``cat`` lays the groups' columns out as ``[primary | group1 | group2 ...]``
(:meth:`RecsysModel.group_columns`). Serving calls ``apply_dense`` with
pooled embeddings (the wide block, the extra groups' blocks) from the HPS.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (
    DATA_PARALLEL, SINGLE_DEVICE, EmbeddingTableConfig, RecsysConfig)
from repro_torch.core.embedding.collection import EmbeddingCollection
from repro_torch.core.embedding.planner import choose_comm, resolve_strategies
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.models.recsys import dense_graph, layers

#: the paper's recipes (any other graph is ``model="graph"``)
MODELS = ("dlrm", "dcn", "deepfm", "wdl")
#: the recipes with a dim-1 wide branch
WIDE_MODELS = ("deepfm", "wdl")


def has_wide(cfg: RecsysConfig) -> bool:
    """Whether ``cfg`` has the dim-1 wide twins (WDL, DeepFM, or a graph
    with ``wide_branch``)."""
    return cfg.model in WIDE_MODELS or (cfg.model == "graph"
                                        and cfg.wide_branch)


def wide_tables(cfg: RecsysConfig) -> Tuple[EmbeddingTableConfig, ...]:
    """The dim-1 first-order ("wide") twin of every table, ``<name>_wide``
    and ``data_parallel``: WDL and DeepFM derive their wide branch from the
    deep tables, so the serving side rebuilds it from the config alone."""
    return tuple(
        dataclasses.replace(t, name=f"{t.name}_wide", dim=1,
                            strategy=DATA_PARALLEL)
        for t in cfg.tables)


class RecsysModel:
    """``use_kernels`` (default True) sends the pooled lookups through
    K1/K3 and the dot interaction through K2/K4, whose wrappers launch the
    CUDA kernels for CUDA tensors; ``False`` runs the plain versions on any
    device (the in-port reference path). ``global_batch`` is the batch the
    placement planner sizes the embedding groups for (the ``Solver``
    default unless given), as in the reference; ``comm`` is its exchange
    knob, ``"auto"`` resolved per collection by ``planner.choose_comm``
    (all-to-all for groups of large one-hot tables, at least
    ``a2a_threshold`` rows; see :class:`EmbeddingCollection`).

    With a ``mesh`` (``launch.mesh.make_test_mesh``; one rank a device)
    the planner sizes the groups for it, each rank holds its shard of the
    sharded groups (over every axis, or ``embed_shard_axes="model"``) and
    a replica of the rest, and ``apply`` takes this rank's data-parallel
    batch block; the model runs on the rank's device."""

    def __init__(self, cfg: RecsysConfig, *, device: DeviceLike = None,
                 use_kernels: bool = True, global_batch: int = 256,
                 comm: str = "allgather_rs", mesh=None,
                 a2a_threshold: int = 65536,
                 embed_shard_axes: str = "all"):
        if cfg.model not in MODELS + ("graph",):
            raise ValueError(f"unknown model {cfg.model!r}")
        if cfg.model == "dlrm" and cfg.bottom_mlp[-1] != cfg.embedding_dim:
            raise ValueError(
                "DLRM needs bottom_mlp[-1] == embedding_dim for the "
                f"interaction, got {cfg.bottom_mlp[-1]} != "
                f"{cfg.embedding_dim}")
        self.cfg = cfg
        self.mesh = mesh
        self.device = (meshlib.mesh_device(mesh) if mesh is not None
                       else resolve_device(device))
        self.compute_dtype = layers.compute_dtype(cfg.dtype)
        self.use_kernels = use_kernels
        mesh_cfg = meshlib.mesh_config_for(mesh) if mesh is not None \
            else SINGLE_DEVICE

        def collection(tables, shard_axes="all"):
            # "auto" resolves PER COLLECTION: each group gets the exchange
            # its table sizes want
            pick = comm if comm != "auto" else \
                choose_comm(tables, threshold=a2a_threshold)
            return EmbeddingCollection(
                tables, mesh=mesh, comm=pick,
                compute_dtype=self.compute_dtype, shard_axes=shard_axes,
                device=self.device, use_kernels=use_kernels)

        self.embedding = collection(
            resolve_strategies(cfg.tables, mesh_cfg, global_batch),
            embed_shard_axes)
        #: the wide twins, pooled through the same K1 / K3 path on CUDA
        #: (the reference gathers them with plain jnp: the same function)
        self.wide: Optional[EmbeddingCollection] = None
        if has_wide(cfg):
            self.wide = collection(wide_tables(cfg))
        #: one collection per extra group, each with its own planner
        #: groups (param key ``embedding@<name>``)
        self.extra: Dict[str, EmbeddingCollection] = {
            g.name: collection(resolve_strategies(g.tables, mesh_cfg,
                                                  global_batch),
                               embed_shard_axes)
            for g in cfg.extra_groups}
        cols = {"embedding": (0, len(cfg.tables))}
        off = len(cfg.tables)
        for g in cfg.extra_groups:
            cols[f"embedding@{g.name}"] = (off, off + len(g.tables))
            off += len(g.tables)
        self._group_cols = cols
        self.program = dense_graph.program_for(cfg, use_kernels=use_kernels)
        if self.device.type == "cuda":
            layers.pin_f32_matmul()

    def collections(self) -> Dict[str, EmbeddingCollection]:
        """Every embedding collection keyed by its param-tree key."""
        out = {"embedding": self.embedding}
        if self.wide is not None:
            out["wide_embedding"] = self.wide
        for name, coll in self.extra.items():
            out[f"embedding@{name}"] = coll
        return out

    def group_columns(self) -> Dict[str, Tuple[int, int]]:
        """``cat`` column ``(start, stop)`` per lookup key (the wide twins
        read the primary columns, so they are not listed)."""
        return dict(self._group_cols)

    def init(self, generator: Optional[torch.Generator] = None) -> Dict:
        """The param tree on the model's device, drawn from ``generator``
        (a CPU generator; seed 0 if omitted): the dense layers first, then
        the tables, the wide twins and the extra groups in declared order.
        ``{"embedding": {group: mega-table}, ...}`` plus, by recipe,
        ``bottom``/``top`` (DLRM), ``cross``/``deep``/``combine`` (DCN) or
        ``deep``/``dense_w``/``bias`` and ``wide_embedding`` (DeepFM,
        WDL); a graph's layers under their output tensor's name,
        ``wide_embedding`` with ``wide_branch`` and one
        ``embedding@<group>`` per extra group."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg, dev = self.cfg, self.device
        nd = cfg.num_dense_features
        in_dim = nd + cfg.num_tables * cfg.embedding_dim
        if cfg.model == "graph":
            params = self.program.init(generator, device=dev)
        elif cfg.model == "dlrm":
            f = cfg.num_tables + 1
            top_in = cfg.bottom_mlp[-1] + f * (f - 1) // 2
            params = {
                "bottom": layers.mlp_init(generator, nd, cfg.bottom_mlp,
                                          device=dev),
                "top": layers.mlp_init(generator, top_in, cfg.top_mlp,
                                       device=dev),
            }
        elif cfg.model == "dcn":
            params = {
                "cross": layers.cross_init(generator, in_dim,
                                           cfg.num_cross_layers, device=dev),
                "deep": layers.mlp_init(generator, in_dim, cfg.top_mlp,
                                        device=dev),
                "combine": layers.mlp_init(
                    generator, in_dim + cfg.top_mlp[-1], (1,), device=dev),
            }
        else:                                   # deepfm, wdl
            params = {
                "deep": layers.mlp_init(generator, in_dim,
                                        cfg.top_mlp + (1,), device=dev),
                "dense_w": (torch.randn((nd,), generator=generator)
                            * 0.01).to(dev),
                "bias": torch.zeros((), device=dev),
            }
        params["embedding"] = self.embedding.init(generator)
        for key, coll in self.collections().items():
            if key != "embedding":
                params[key] = coll.init(generator)
        return params

    def apply(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Logits ``[B]`` from a device batch (``dense``, ``cat``): each
        collection pools its own ``cat`` columns; the wide twins read the
        primary tables' columns."""
        cat = batch["cat"]

        def columns(key):
            lo, hi = self._group_cols[key]
            return cat[:, lo:hi]

        emb = self.embedding.lookup(params["embedding"], columns("embedding"))
        wide = None
        if self.wide is not None:
            wide = self.wide.lookup(params["wide_embedding"],
                                    columns("embedding"))
        extras = {name: coll.lookup(params[f"embedding@{name}"],
                                    columns(f"embedding@{name}"))
                  for name, coll in self.extra.items()}
        return self.apply_dense(params, batch["dense"], emb, wide,
                                extras=extras)

    def apply_dense(self, params: Dict, dense: torch.Tensor,
                    emb: torch.Tensor, wide: Optional[torch.Tensor] = None,
                    *, extras: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
        """Logits ``[B]`` from dense features ``[B, Nd]``, pooled
        embeddings ``[B, T, D]``, for wide models the pooled wide twins
        ``[B, T, 1]`` and for N-group models each extra group's pooled
        block by group name (the serving entry point)."""
        if (wide is None) != (self.wide is None):
            raise ValueError(
                f"model {self.cfg.model!r} "
                + ("needs" if self.wide is not None else "takes no")
                + " wide block")
        missing = set(self.extra) - set(extras or {})
        if missing:
            raise ValueError(f"model {self.cfg.name!r} needs the pooled "
                             f"blocks of extra groups {sorted(missing)}")
        env = self.program.make_env(dense, emb, wide, self.compute_dtype,
                                    extras=extras)
        return self.program.apply(params, env, self.compute_dtype)

    def loss_fn(self, params: Dict, batch: Dict) -> torch.Tensor:
        return layers.bce_with_logits(self.apply(params, batch),
                                      batch["label"])

    def sharded_keys(self) -> Dict[str, Tuple[str, ...]]:
        """Flat param paths (``"embedding/dist"``...) of the tables sharded
        over a mesh, each with the axes it is replicated over (``()`` when
        sharded over every axis; the DP axes for ``embed_shard_axes=
        "model"``); every other parameter is replicated over all axes."""
        return {f"{key}/{g}": coll.replica_axes(g)
                for key, coll in self.collections().items()
                for g in coll.sharded_keys()}


def export_logical_params(model: RecsysModel, params: Dict) -> Dict:
    """Param tree with embedding groups in the LOGICAL (mesh-independent)
    layout: the checkpoint format shared with the reference."""
    out = dict(params)
    for key, coll in model.collections().items():
        if key in out:
            out[key] = coll.export_logical(out[key])
    return out


def import_logical_params(model: RecsysModel, params: Dict) -> Dict:
    """Inverse of :func:`export_logical_params`."""
    out = dict(params)
    for key, coll in model.collections().items():
        if key in out:
            out[key] = coll.import_logical(out[key])
    return out


def export_opt_state(model: RecsysModel, opt_state: Dict) -> Dict:
    """``opt_state`` as the trainer's checkpoint holds it: the sparse
    optimizer's per-row state of every collection whole, in the physical
    layout (``EmbeddingCollection.export_acc``; a collective on a mesh);
    the dense state as it is (replicated)."""
    sparse = opt_state.get("sparse", {})
    if "acc" not in sparse:
        return opt_state
    acc = dict(sparse["acc"])
    for key, coll in model.collections().items():
        if key in acc:
            acc[key] = coll.export_acc(acc[key])
    return {**opt_state, "sparse": {**sparse, "acc": acc}}


def import_opt_state(model: RecsysModel, opt_state: Dict) -> Dict:
    """Inverse of :func:`export_opt_state` for ``model``'s mesh."""
    sparse = opt_state.get("sparse", {})
    if "acc" not in sparse:
        return opt_state
    acc = dict(sparse["acc"])
    for key, coll in model.collections().items():
        if key in acc:
            acc[key] = coll.import_acc(acc[key])
    return {**opt_state, "sparse": {**sparse, "acc": acc}}


def logical_tables(collection: EmbeddingCollection,
                   emb_params: Dict) -> Dict[str, np.ndarray]:
    """Per-table LOGICAL weights (unpadded, hot+cold merged) keyed by
    table name, host f32: the export shape the PDB, the ETC's parameter
    server and the portable converter consume."""
    return collection.logical_tables(emb_params)


def import_logical_tables(collection: EmbeddingCollection, emb_params: Dict,
                          tables: Dict[str, np.ndarray]) -> Dict:
    """Inverse of :func:`logical_tables`: write per-table FULL weight
    arrays back into the collection's logical layout and import it onto
    the collection's device. ``emb_params`` supplies the layout template
    (and the values of any table absent from ``tables``) — the ETC trainer
    uses this to fold parameter-server contents back into a servable
    param tree."""
    logical = {k: v.detach().float().cpu().numpy().copy()
               for k, v in collection.export_logical(emb_params).items()}
    for gname, group in collection.groups.items():
        if gname == "cold":
            continue               # written through "hot" below
        for i, t in enumerate(group.tables):
            if t.name not in tables:
                continue
            full = np.asarray(tables[t.name], np.float32)
            if full.shape != (t.vocab_size, t.dim):
                raise ValueError(
                    f"table {t.name}: got {full.shape}, want "
                    f"({t.vocab_size}, {t.dim})")
            if gname == "loc":
                logical["loc"][i][:t.vocab_size] = full
                continue
            lo, hi = group.table_rows(i)
            if gname == "hot":
                clo, chi = collection.groups["cold"].table_rows(i)
                logical["hot"][lo:hi] = full[:hi - lo]
                logical["cold"][clo:chi] = full[hi - lo:]
            else:
                logical[gname][lo:hi] = full
    return collection.import_logical(logical)
