"""DLRM as ``RecsysModel`` (counterpart of ``repro/models/recsys/model.py``):
the embedding collection (the sparse half, trained), DLRM's ``bottom``/
``top`` MLPs (the dense half), ``apply``, ``loss_fn`` and the logical
checkpoint layout.

``apply(params, batch)`` returns logits ``[B]``; ``loss_fn`` adds BCE.
batch = {"dense": [B, Nd] f32, "cat": [B, T, H] int32 (-1 pad), "label": [B]}
Serving calls ``apply_dense`` with pooled embeddings from the HPS.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import SINGLE_DEVICE, RecsysConfig
from repro_torch.core.embedding.collection import EmbeddingCollection
from repro_torch.core.embedding.planner import resolve_strategies
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys import dense_graph, layers


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
        if cfg.model != "dlrm":
            raise dense_graph.not_ported(f"model {cfg.model!r}")
        if cfg.bottom_mlp[-1] != cfg.embedding_dim:
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
        self.program = dense_graph.canonical_program(
            cfg, use_kernels=use_kernels)
        if self.device.type == "cuda":
            layers.pin_f32_matmul()

    def collections(self) -> Dict[str, EmbeddingCollection]:
        """Every embedding collection keyed by its param-tree key."""
        return {"embedding": self.embedding}

    def init(self, generator: Optional[torch.Generator] = None) -> Dict:
        """``{"embedding": {group: mega-table}, "bottom": {...}, "top":
        {...}}`` on the model's device, drawn from ``generator`` (a CPU
        generator; seed 0 if omitted): the dense MLPs first, then the
        tables."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = self.cfg
        f = cfg.num_tables + 1
        top_in = cfg.bottom_mlp[-1] + f * (f - 1) // 2
        params = {
            "bottom": layers.mlp_init(generator, cfg.num_dense_features,
                                      cfg.bottom_mlp, device=self.device),
            "top": layers.mlp_init(generator, top_in, cfg.top_mlp,
                                   device=self.device),
        }
        params["embedding"] = self.embedding.init(generator)
        return params

    def apply(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Logits ``[B]`` from a device batch (``dense``, ``cat``)."""
        emb = self.embedding.lookup(params["embedding"], batch["cat"])
        return self.apply_dense(params, batch["dense"], emb)

    def apply_dense(self, params: Dict, dense: torch.Tensor,
                    emb: torch.Tensor) -> torch.Tensor:
        """Logits ``[B]`` from dense features ``[B, Nd]`` and pooled
        embeddings ``[B, T, D]`` (the serving entry point)."""
        env = self.program.make_env(dense, emb, self.compute_dtype)
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
