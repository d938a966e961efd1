"""Entry points over the kernels (counterparts of ``repro/kernels/ops.py``):
the serving reads ``pooled_cache_lookup`` and ``cache_gather``, and the
differentiable ``fused_embedding_lookup`` / ``kernel_pool`` and
``dot_interaction`` that training runs.

Each picks by the tensors' device, through its kernel's wrapper: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors. The JAX
package padded inputs to the Pallas kernels' block shapes; the CUDA
kernels take any shape, so nothing is padded here. The JAX ``custom_vjp``s
become ``torch.autograd.Function``s whose backward is the adjoint kernel
(K3 for the lookup, K4 for the interaction).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dot_interaction import interaction_bwd, interaction_fwd
from repro_torch.kernels.embedding_lookup import lookup_bwd, lookup_fwd
from repro_torch.kernels.hps_gather import dequant_gather_rows, gather_rows
from repro_torch.kernels.ref import acc_dtype


def pooled_cache_lookup(payload: torch.Tensor, slots: torch.Tensor,
                        scales: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``payload [C, D]``, ``slots [B, H]`` int32 (-1 = hole) -> sum-pooled
    ``[B, D]`` f32. With per-row ``scales`` (int8 payloads) the rows come
    from the dequantizing gather K6 and are summed over H; otherwise the
    pooled gather K1 reads the payload directly."""
    if scales is not None:
        b, h = slots.shape
        rows = dequant_gather_rows(payload, scales, slots.reshape(-1))
        rows = rows.view(b, h, -1)
        return rows[:, 0] if h == 1 else rows.sum(dim=1)
    return lookup_fwd(payload, slots)


def cache_gather(payload: torch.Tensor, slots: torch.Tensor, *,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``payload [C, D]``, ``slots [N]`` int32 (-1 = hole -> zero row) ->
    ``[N, D]`` f32, through K6 when ``scales`` is given and K5 otherwise."""
    if scales is not None:
        return dequant_gather_rows(payload, scales, slots)
    return gather_rows(payload, slots)


# ---------------------------------------------------------------------------
# Training: the pooled lookup (K1 forward, K3 backward)
# ---------------------------------------------------------------------------

class _FusedLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, rows):
        ctx.table_shape = tuple(table.shape)
        ctx.save_for_backward(rows)
        return lookup_fwd(table, rows)

    @staticmethod
    def backward(ctx, dpooled):
        rows, = ctx.saved_tensors
        dpooled = dpooled.to(acc_dtype(dpooled.dtype)).contiguous()
        return lookup_bwd(ctx.table_shape, rows, dpooled), None


def fused_embedding_lookup(table: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """``table [V, D]``, ``rows [B, H]`` int32 (-1 pad) -> sum-pooled
    ``[B, D]`` f32; the gradient reaches ``table`` as the dense ``[V, D]``
    f32 adjoint."""
    return _FusedLookup.apply(table, rows)


def kernel_pool(mega: torch.Tensor, rows: torch.Tensor, *,
                combiner: str = "sum",
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``rows [B, T, H]`` mega-table row ids (-1 pad) -> ``[B, T, D]``,
    in the reference's cast order: an f32 pool, the mean renorm, then the
    compute dtype."""
    b, t, h = rows.shape
    out = fused_embedding_lookup(mega, rows.reshape(b * t, h))
    out = out.reshape(b, t, -1)
    if combiner == "mean":
        denom = (rows >= 0).sum(-1, keepdim=True).clamp_min(1)
        out = out / denom.to(out.dtype)
    if compute_dtype is not None:
        out = out.to(compute_dtype)
    return out


# ---------------------------------------------------------------------------
# DLRM dot interaction (K2 forward, K4 backward)
# ---------------------------------------------------------------------------

class _DotInteraction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, self_interaction):
        ctx.self_interaction = self_interaction
        ctx.save_for_backward(x)
        # K2 reads f32 (the TPU kernel cast its tile to f32 the same way)
        return interaction_fwd(x.to(acc_dtype(x.dtype)),
                               self_interaction=self_interaction)

    @staticmethod
    def backward(ctx, dtri):
        x, = ctx.saved_tensors
        dtri = dtri.to(acc_dtype(dtri.dtype)).contiguous()
        return interaction_bwd(x, dtri,
                               self_interaction=ctx.self_interaction), None


def dot_interaction(x: torch.Tensor,
                    self_interaction: bool = False) -> torch.Tensor:
    """``x [B, F, D]`` -> pairwise-dot triangle ``[B, P]`` f32 (K2); the
    gradient ``dx`` comes from K4 in ``x``'s type."""
    return _DotInteraction.apply(x, self_interaction)
