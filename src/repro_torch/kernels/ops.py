"""Serving-path entry points over the kernels (counterparts of
``repro/kernels/ops.py``: ``pooled_cache_lookup``, ``cache_gather`` and
``dot_interaction``).

Each picks by the tensors' device, through its kernel's wrapper: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors. The JAX
package padded inputs to the Pallas kernels' block shapes; the CUDA
kernels take any shape, so nothing is padded here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dot_interaction import interaction_fwd
from repro_torch.kernels.embedding_lookup import lookup_fwd
from repro_torch.kernels.hps_gather import dequant_gather_rows, gather_rows


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


def dot_interaction(x: torch.Tensor,
                    self_interaction: bool = False) -> torch.Tensor:
    """``x [B, F, D]`` -> pairwise-dot triangle ``[B, P]`` (K2)."""
    return interaction_fwd(x, self_interaction=self_interaction)
