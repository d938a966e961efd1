"""Dense layers of the recsys models (counterpart of
``repro/models/recsys/layers.py``: ``mlp_init``, ``mlp_apply``, DCN's
``cross_init`` / ``cross_apply``, DeepFM's ``fm_second_order``, the loss
``bce_with_logits`` and the eval metric ``auc``).

``mlp_apply`` reproduces the JAX rounding order exactly: operands rounded
to the compute dtype, a product accumulated in f32, the f32 bias added,
ReLU, and only then the round to the compute dtype. A bf16 ``torch.matmul``
would round its output before the bias, so the product here is an f32
matmul of the already-rounded operands (bf16 x bf16 products are exact in
f32). TF32 must be off for that matmul to be f32 on the card; the serving
entry points pin ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False. ``cross_apply`` keeps the
reference's order the same way: ``x . w`` an f32 product of the rounded
operands, then each elementwise op of the update in the compute dtype.

The weight of such a product is rounded by ``rounded_weight``. Its gradient
(an f32 product summed over the batch) is rounded to the compute dtype, as
the cast's adjoint does, unless the step holds ``deferred_rounding``: then
it comes back unrounded, and the step rounds it after its sum over the
ranks of a mesh. That is the reference's order on a mesh, where XLA sums the
partial products of the data-parallel batch blocks before the cast, so a
(2, 2) run rounds the weight gradients where a one-device run does.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def pin_f32_matmul() -> None:
    """Full-f32 matmuls on the card (no TF32), as the reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


#: ``id(weight) -> compute dtype`` of the weights whose gradient rounding
#: the running step has taken over (None: round in the backward)
_DEFERRED: contextvars.ContextVar[Optional[Dict[int, torch.dtype]]] = \
    contextvars.ContextVar("deferred_rounding", default=None)


class _Rounded(torch.autograd.Function):
    """``w`` rounded to ``dtype`` as f32 values; the gradient passes
    through unrounded (f32)."""

    @staticmethod
    def forward(ctx, w, dtype):
        return w.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def rounded_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` rounded to the compute dtype, as f32 values for an f32
    product (see the module docstring for its gradient)."""
    deferred = _DEFERRED.get()
    if deferred is None or dtype == torch.float32 or not w.requires_grad:
        return w.to(dtype).float()
    deferred[id(w)] = dtype
    return _Rounded.apply(w, dtype)


@contextlib.contextmanager
def deferred_rounding() -> Iterator[Dict[int, torch.dtype]]:
    """Inside, ``rounded_weight`` leaves its gradient unrounded and records
    ``id(weight) -> dtype`` in the dict it yields."""
    token = _DEFERRED.set({})
    try:
        yield _DEFERRED.get()
    finally:
        _DEFERRED.reset(token)


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
        w = rounded_weight(params[f"w{i}"], compute_dtype)
        h = torch.matmul(h.float(), w) + params[f"b{i}"]
        if i < n - 1 or final_activation:
            h = torch.relu(h)
        h = h.to(compute_dtype)
    return h.float()


def cross_init(generator: torch.Generator, dim: int, n_layers: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    """DCN cross layers: ``w{i} [dim]`` normal / sqrt(dim) and zero
    ``b{i} [dim]``, drawn on the CPU from ``generator``."""
    params = {}
    for i in range(n_layers):
        w = torch.randn((dim,), generator=generator,
                        dtype=torch.float32) / math.sqrt(dim)
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros((dim,), dtype=torch.float32,
                                      device=device)
    return params


def cross_apply(params: Dict[str, torch.Tensor], x0: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """DCN cross network ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``:
    ``x0 [B, n]`` -> ``[B, n]`` f32. ``x_l . w_l`` accumulates in f32 over
    the rounded operands and is rounded once; the update rounds after each
    op, in the reference's order."""
    n = len(params) // 2
    x0c = x0.to(compute_dtype)
    x = x0c
    for i in range(n):
        w = rounded_weight(params[f"w{i}"], compute_dtype)
        xw = torch.matmul(x.float(), w)
        x = x0c * xw[:, None].to(compute_dtype) \
            + params[f"b{i}"].to(compute_dtype) + x
    return x.float()


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """FM pairwise term in f32: ``emb [B, T, D]`` -> ``[B, D]``,
    ``0.5 * ((sum_t v_t)^2 - sum_t v_t^2)``."""
    e = emb.float()
    s = e.sum(dim=1)
    sq = (e * e).sum(dim=1)
    return 0.5 * (s * s - sq)


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
