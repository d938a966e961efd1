"""K2: DLRM pairwise dot interaction (``csrc/dot_interaction.cu``).

Counterpart of ``repro/kernels/dot_interaction.py::interaction_fwd``. The
TPU kernel compacted the Gram matrix's lower triangle with a selection
matmul; the CUDA kernel indexes the triangle directly, so there is no
selection matrix here. On CPU tensors :func:`interaction_fwd` runs the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dot_interaction_ref as interaction_fwd_plain

NAME = "interaction_fwd"
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
