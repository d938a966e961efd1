"""Dense layers of the recsys models (counterpart of
``repro/models/recsys/layers.py``: ``mlp_init``, ``mlp_apply``, the loss
``bce_with_logits`` and the eval metric ``auc``).

``mlp_apply`` reproduces the JAX rounding order exactly: operands rounded
to the compute dtype, a product accumulated in f32, the f32 bias added,
ReLU, and only then the round to the compute dtype. A bf16 ``torch.matmul``
would round its output before the bias, so the product here is an f32
matmul of the already-rounded operands (bf16 x bf16 products are exact in
f32). TF32 must be off for that matmul to be f32 on the card; the serving
entry points pin ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def pin_f32_matmul() -> None:
    """Full-f32 matmuls on the card (no TF32), as the reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mlp_init(generator: torch.Generator, in_dim: int,
             sizes: Sequence[int], *, device=None) -> Dict[str, torch.Tensor]:
    """He-normal weights ``w{i} [fan_in, fan_out]`` and zero biases
    ``b{i}``, drawn on the CPU from ``generator`` (so a seed gives the same
    weights on every device), then moved to ``device``."""
    params = {}
    dims = [in_dim] + list(sizes)
    for i in range(len(sizes)):
        fan_in, fan_out = dims[i], dims[i + 1]
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / fan_in)
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros((fan_out,), dtype=torch.float32,
                                      device=device)
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
              final_activation: bool = False,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    n = len(params) // 2
    h = x.to(compute_dtype)
    for i in range(n):
        w = params[f"w{i}"].to(compute_dtype)
        h = torch.matmul(h.float(), w.float()) + params[f"b{i}"]
        if i < n - 1 or final_activation:
            h = torch.relu(h)
        h = h.to(compute_dtype)
    return h.float()


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean binary cross entropy, in the reference's
    formula (``max(z, 0) - z y + log1p(exp(-|z|))``)."""
    z = logits.float()
    y = labels.float()
    return torch.mean(torch.clamp_min(z, 0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def auc(logits: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (host-side eval metric, the paper's model metric)."""
    order = np.argsort(logits)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
