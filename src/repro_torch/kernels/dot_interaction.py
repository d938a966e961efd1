"""K2 and K4: DLRM pairwise dot interaction and its adjoint
(``csrc/dot_interaction.cu``).

Counterparts of ``repro/kernels/dot_interaction.py::interaction_fwd`` and
``::interaction_bwd``. The TPU kernels compacted (and scattered back) the
Gram matrix's lower triangle with a selection matmul; the CUDA kernels
index the triangle directly, so there is no selection matrix here. On CPU
tensors each wrapper runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dot_interaction_bwd_ref as interaction_bwd_plain
from repro_torch.kernels.ref import dot_interaction_ref as interaction_fwd_plain

NAME = "interaction_fwd"
NAME_BWD = "interaction_bwd"
#: dynamic shared memory one block may use on Hopper (x[b] is staged there)
MAX_SMEM_BYTES = 227 * 1024


def num_pairs(f: int, self_interaction: bool = False) -> int:
    return f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2


def interaction_fwd(x: torch.Tensor, *,
                    self_interaction: bool = False) -> torch.Tensor:
    """``x [B, F, D]`` f32 -> ``[B, P]`` f32, the (strict, or with the
    diagonal when ``self_interaction``) lower triangle of each ``x x^T``
    in ``np.tril_indices`` order."""
    if _build.on_cpu(x):
        return interaction_fwd_plain(x, self_interaction=self_interaction)
    _build.require_cuda("x", x, (torch.float32,), 3)
    b, f, d = x.shape
    _build.require(f * (d + 1) * 4 <= MAX_SMEM_BYTES,
                   f"x[b] of {f}x{d} floats does not fit in shared memory")
    out = torch.empty((b, num_pairs(f, self_interaction)),
                      dtype=torch.float32, device=x.device)
    _build.launch(NAME, "repro_interaction_fwd", x.device, x.data_ptr(),
                  out.data_ptr(), b, f, d, int(self_interaction))
    return out


def interaction_bwd(x: torch.Tensor, dtri: torch.Tensor, *,
                    self_interaction: bool = False) -> torch.Tensor:
    """``x [B, F, D]`` (f32 or bf16), ``dtri [B, P]`` f32 -> ``dx [B, F,
    D]`` in ``x``'s type: ``(G + G^T) x`` with ``G`` holding ``dtri`` on
    its lower triangle."""
    if _build.on_cpu(x, dtri):
        return interaction_bwd_plain(x, dtri,
                                     self_interaction=self_interaction)
    _build.require_cuda("x", x, (torch.float32, torch.bfloat16), 3)
    _build.require_cuda("dtri", dtri, (torch.float32,), 2)
    b, f, d = x.shape
    p = num_pairs(f, self_interaction)
    _build.require(tuple(dtri.shape) == (b, p),
                   f"dtri {tuple(dtri.shape)} != ({b}, {p})")
    _build.require(x.device == dtri.device,
                   f"x on {x.device}, dtri on {dtri.device}")
    _build.require((f * d + f * f) * 4 <= MAX_SMEM_BYTES,
                   f"x[b] of {f}x{d} and its {f}x{f} S do not fit in shared "
                   "memory")
    dx = torch.empty_like(x)
    _build.launch(NAME_BWD, "repro_interaction_bwd", x.device, x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], dtri.data_ptr(), dx.data_ptr(),
                  b, f, d, int(self_interaction))
    return dx
