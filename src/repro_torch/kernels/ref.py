"""Plain PyTorch versions of the kernels.

Twins of ``repro/kernels/ref.py`` (the JAX package's test oracles). Each
is the CPU implementation behind its kernel's wrapper and the reference
``chip_smoke.py`` holds the CUDA kernel against on the card. Sums run in
f32, or in f64 for f64 inputs (the gradient checks).
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


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
                                   device=vecs.device)).to(
        acc_dtype(table.dtype))
    pooled = vecs.sum(dim=1)
    if combiner == "mean":
        denom = valid.sum(dim=1, keepdim=True).clamp_min(1)
        pooled = pooled / denom.to(pooled.dtype)
    return pooled


def embedding_grad_ref(table_shape, rows: torch.Tensor,
                       dpooled: torch.Tensor) -> torch.Tensor:
    """Adjoint of the sum-pooled lookup: ``rows [B, H]`` (-1 = pad),
    ``dpooled [B, D]`` -> ``dtable [V, D]`` f32, the scatter-add of
    ``dpooled[b]`` into every valid ``rows[b, h]`` (duplicates count
    multiply; ids outside ``[0, V)`` are dropped)."""
    v, d = table_shape
    valid = (rows >= 0) & (rows < v)
    flat = torch.where(valid, rows, torch.full_like(rows, v)).reshape(-1)
    dt = acc_dtype(dpooled.dtype)
    contrib = dpooled.to(dt)[:, None, :].expand(*rows.shape, d)
    contrib = torch.where(valid[..., None], contrib,
                          torch.zeros((), dtype=dt, device=contrib.device))
    out = torch.zeros((v + 1, d), dtype=dt, device=dpooled.device)
    out.index_add_(0, flat.long(), contrib.reshape(-1, d))
    return out[:v]


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


def _tril(f: int, self_interaction: bool, device):
    return torch.tril_indices(f, f, 0 if self_interaction else -1,
                              device=device)


def dot_interaction_ref(x: torch.Tensor, *,
                        self_interaction: bool = False) -> torch.Tensor:
    """DLRM pairwise dots: ``x [B, F, D]`` -> the strict lower triangle of
    each ``x x^T`` in ``np.tril_indices`` order, ``[B, F(F-1)/2]`` (with
    the diagonal, ``F(F+1)/2``, when ``self_interaction``)."""
    xf = x.to(acc_dtype(x.dtype))
    gram = torch.matmul(xf, xf.transpose(1, 2))
    i, j = _tril(x.shape[1], self_interaction, x.device)
    return gram[:, i, j]


def dot_interaction_bwd_ref(x: torch.Tensor, dtri: torch.Tensor, *,
                            self_interaction: bool = False) -> torch.Tensor:
    """Adjoint of :func:`dot_interaction_ref`: ``dx = (G + G^T) x`` with
    ``G [B, F, F]`` holding ``dtri`` on its (strict) lower triangle; the
    symmetrization doubles the diagonal. Returns ``dx`` in ``x``'s type."""
    b, f, _ = x.shape
    dt = acc_dtype(x.dtype)
    i, j = _tril(f, self_interaction, x.device)
    g = torch.zeros((b, f, f), dtype=dt, device=x.device)
    g[:, i, j] = dtri.to(dt)
    return torch.matmul(g + g.transpose(1, 2), x.to(dt)).to(x.dtype)
