"""The paper's four recipes as ``RecsysModel`` (counterpart of
``repro/models/recsys/model.py``): DLRM, DCN, DeepFM and Wide&Deep. The
sparse half is the embedding collection and, for WDL and DeepFM, a second
collection of the tables' dim-1 "wide" twins (param key
``wide_embedding``, every twin ``data_parallel``); the dense half is the
recipe's layers (``bottom``/``top``; ``cross``/``deep``/``combine``;
``deep``/``dense_w``/``bias``), run by the compiled dense program.

``apply(params, batch)`` returns logits ``[B]``; ``loss_fn`` adds BCE.
batch = {"dense": [B, Nd] f32, "cat": [B, T, H] int32 (-1 pad), "label": [B]}
Serving calls ``apply_dense`` with pooled embeddings (and the wide block)
from the HPS.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (
    DATA_PARALLEL, SINGLE_DEVICE, EmbeddingTableConfig, RecsysConfig)
from repro_torch.core.embedding.collection import EmbeddingCollection
from repro_torch.core.embedding.planner import resolve_strategies
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys import dense_graph, layers
from repro_torch.roadmap import RECIPES_3B, not_ported

#: the recipes this port builds (``model="graph"`` is the ROADMAP item
#: "The other recipes and graphs", part 3b)
MODELS = ("dlrm", "dcn", "deepfm", "wdl")
#: the recipes with a dim-1 wide branch
WIDE_MODELS = ("deepfm", "wdl")


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
    knob (see :class:`EmbeddingCollection`)."""

    def __init__(self, cfg: RecsysConfig, *, device: DeviceLike = None,
                 use_kernels: bool = True, global_batch: int = 256,
                 comm: str = "allgather_rs"):
        if cfg.model not in MODELS:
            raise not_ported(f"model {cfg.model!r}", RECIPES_3B)
        if cfg.model == "dlrm" and cfg.bottom_mlp[-1] != cfg.embedding_dim:
            raise ValueError(
                "DLRM needs bottom_mlp[-1] == embedding_dim for the "
                f"interaction, got {cfg.bottom_mlp[-1]} != "
                f"{cfg.embedding_dim}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = layers.compute_dtype(cfg.dtype)
        self.use_kernels = use_kernels
        self.embedding = EmbeddingCollection(
            resolve_strategies(cfg.tables, SINGLE_DEVICE, global_batch),
            comm=comm, compute_dtype=self.compute_dtype, device=self.device,
            use_kernels=use_kernels)
        #: the wide twins, pooled through the same K1 / K3 path on CUDA
        #: (the reference gathers them with plain jnp: the same function)
        self.wide: Optional[EmbeddingCollection] = None
        if cfg.model in WIDE_MODELS:
            self.wide = EmbeddingCollection(
                wide_tables(cfg), comm=comm,
                compute_dtype=self.compute_dtype, device=self.device,
                use_kernels=use_kernels)
        self.program = dense_graph.canonical_program(
            cfg, use_kernels=use_kernels)
        if self.device.type == "cuda":
            layers.pin_f32_matmul()

    def collections(self) -> Dict[str, EmbeddingCollection]:
        """Every embedding collection keyed by its param-tree key."""
        out = {"embedding": self.embedding}
        if self.wide is not None:
            out["wide_embedding"] = self.wide
        return out

    def init(self, generator: Optional[torch.Generator] = None) -> Dict:
        """The param tree on the model's device, drawn from ``generator``
        (a CPU generator; seed 0 if omitted): the dense layers first, then
        the tables, then the wide twins. ``{"embedding": {group:
        mega-table}, ...}`` plus, by recipe, ``bottom``/``top`` (DLRM),
        ``cross``/``deep``/``combine`` (DCN) or ``deep``/``dense_w``/
        ``bias`` and ``wide_embedding`` (DeepFM, WDL)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg, dev = self.cfg, self.device
        nd = cfg.num_dense_features
        in_dim = nd + cfg.num_tables * cfg.embedding_dim
        if cfg.model == "dlrm":
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
        if self.wide is not None:
            params["wide_embedding"] = self.wide.init(generator)
        return params

    def apply(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Logits ``[B]`` from a device batch (``dense``, ``cat``); the wide
        twins read the same ``cat`` columns as the deep tables."""
        emb = self.embedding.lookup(params["embedding"], batch["cat"])
        wide = None
        if self.wide is not None:
            wide = self.wide.lookup(params["wide_embedding"], batch["cat"])
        return self.apply_dense(params, batch["dense"], emb, wide)

    def apply_dense(self, params: Dict, dense: torch.Tensor,
                    emb: torch.Tensor,
                    wide: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``[B]`` from dense features ``[B, Nd]``, pooled
        embeddings ``[B, T, D]`` and, for wide models, the pooled wide
        twins ``[B, T, 1]`` (the serving entry point)."""
        if (wide is None) != (self.wide is None):
            raise ValueError(
                f"model {self.cfg.model!r} "
                + ("needs" if self.wide is not None else "takes no")
                + " wide block")
        env = self.program.make_env(dense, emb, wide, self.compute_dtype)
        return self.program.apply(params, env, self.compute_dtype)

    def loss_fn(self, params: Dict, batch: Dict) -> torch.Tensor:
        return layers.bce_with_logits(self.apply(params, batch),
                                      batch["label"])


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
