"""The dense half of ``RecsysModel`` (counterpart of
``repro/models/recsys/model.py``): DLRM's ``bottom``/``top`` parameter
init and ``apply_dense``. Embeddings are served by the HPS, so this model
owns no tables; the training side (embedding collections, ``apply``,
``loss_fn``) is the next slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys import dense_graph, layers


class RecsysModel:
    """``use_kernels`` (default True) sends the dot interaction through
    the K2 wrapper, which launches the CUDA kernel for CUDA tensors;
    ``False`` runs the plain version on any device (the reference path
    the smoke run compares the served predictions with)."""

    def __init__(self, cfg: RecsysConfig, *, device: DeviceLike = None,
                 use_kernels: bool = True):
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
        self.program = dense_graph.canonical_program(
            cfg, use_kernels=use_kernels)
        if self.device.type == "cuda":
            layers.pin_f32_matmul()

    def init(self, generator: Optional[torch.Generator] = None) -> Dict:
        """Dense params ``{"bottom": {...}, "top": {...}}`` on the model's
        device, drawn from ``generator`` (a CPU generator; seed 0 if
        omitted)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = self.cfg
        f = cfg.num_tables + 1
        top_in = cfg.bottom_mlp[-1] + f * (f - 1) // 2
        return {
            "bottom": layers.mlp_init(generator, cfg.num_dense_features,
                                      cfg.bottom_mlp, device=self.device),
            "top": layers.mlp_init(generator, top_in, cfg.top_mlp,
                                   device=self.device),
        }

    def apply_dense(self, params: Dict, dense: torch.Tensor,
                    emb: torch.Tensor) -> torch.Tensor:
        """Logits ``[B]`` from dense features ``[B, Nd]`` and pooled
        embeddings ``[B, T, D]`` (the serving entry point)."""
        env = self.program.make_env(dense, emb, self.compute_dtype)
        return self.program.apply(params, env, self.compute_dtype)
