"""Plain PyTorch versions of the kernels on the serving path.

Twins of ``repro/kernels/ref.py`` (the JAX package's test oracles). Each
is the CPU implementation behind its kernel's wrapper and the reference
``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import torch


def embedding_lookup_ref(table: torch.Tensor, rows: torch.Tensor,
                         combiner: str = "sum") -> torch.Tensor:
    """``table [V, D]``, ``rows [B, H]`` int (-1 = pad) -> ``[B, D]`` f32.

    Sum (or mean) of the selected rows; duplicate ids count multiply.
    """
    valid = rows >= 0
    safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
    vecs = table[safe]
    vecs = torch.where(valid[..., None], vecs,
                       torch.zeros((), dtype=vecs.dtype,
                                   device=vecs.device)).float()
    pooled = vecs.sum(dim=1)
    if combiner == "mean":
        denom = valid.sum(dim=1, keepdim=True).clamp_min(1)
        pooled = pooled / denom.to(pooled.dtype)
    return pooled


def cache_gather_ref(payload: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """``payload [C, D]``, ``slots [N]`` int (-1 = hole) -> ``[N, D]`` f32."""
    valid = slots >= 0
    safe = torch.where(valid, slots, torch.zeros_like(slots)).long()
    rows = payload[safe].float()
    return torch.where(valid[:, None], rows, torch.zeros((), device=rows.device))


def dequant_gather_ref(payload: torch.Tensor, scales: torch.Tensor,
                       slots: torch.Tensor) -> torch.Tensor:
    """``payload [C, D]`` (int8/f16/f32), ``scales [C]`` f32 per-row
    scale, ``slots [N]`` (-1 = hole) -> ``[N, D]`` f32
    ``payload[s].float() * scales[s]``."""
    valid = slots >= 0
    safe = torch.where(valid, slots, torch.zeros_like(slots)).long()
    rows = payload[safe].float() * scales[safe].float()[:, None]
    return torch.where(valid[:, None], rows, torch.zeros((), device=rows.device))


def dot_interaction_ref(x: torch.Tensor, *,
                        self_interaction: bool = False) -> torch.Tensor:
    """DLRM pairwise dots: ``x [B, F, D]`` -> the strict lower triangle of
    each ``x x^T`` in ``np.tril_indices`` order, ``[B, F(F-1)/2]`` (with
    the diagonal, ``F(F+1)/2``, when ``self_interaction``)."""
    xf = x.float()
    gram = torch.matmul(xf, xf.transpose(1, 2))
    f = x.shape[1]
    i, j = torch.tril_indices(f, f, 0 if self_interaction else -1,
                              device=x.device)
    return gram[:, i, j]
