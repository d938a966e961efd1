"""K2 and K4: DLRM pairwise dot interaction and its adjoint
(``csrc/dot_interaction.cu``).

Counterparts of ``repro/kernels/dot_interaction.py::interaction_fwd`` and
``::interaction_bwd``. The TPU kernels compacted (and scattered back) the
Gram matrix's lower triangle with a selection matmul; the CUDA kernels
index the triangle directly, so there is no selection matrix here. On CPU
tensors each wrapper runs its plain version.
"""
from __future__ import annotations

import numpy as np
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


#: lanes that split one K2 tile's D (``kFwdSlices`` in the CUDA source)
FWD_SLICES = 8


def fwd_tiles(f: int) -> list:
    """K2's 4 x 4 tiles of the padded Gram's lower triangle, in the
    kernel's order: tile ``t = I(I+1)/2 + J`` is ``(I, J)``, ``J <= I``."""
    nt = -(-f // 4)
    return [(ti, tj) for ti in range(nt) for tj in range(ti + 1)]


def fwd_pair_map(f: int, self_interaction: bool = False) -> np.ndarray:
    """The map K2's block builds once (``pmap``): ``[tiles, 16]`` int, entry
    ``e`` of tile ``(I, J)`` is the Gram entry ``(4I + e // 4, 4J + e %
    4)`` and holds its index in ``np.tril_indices`` order, or -1 where the
    entry is above the diagonal (on it, without ``self_interaction``) or
    past ``F``. After the reduce-scatter, lane ``s`` of a tile's
    :data:`FWD_SLICES` holds entries ``2s`` and ``2s + 1``."""
    tiles = fwd_tiles(f)
    out = np.full((len(tiles), 16), -1, dtype=np.int64)
    for t, (ti, tj) in enumerate(tiles):
        for e in range(16):
            i, j = 4 * ti + e // 4, 4 * tj + e % 4
            if i < f and (j < i or (self_interaction and j == i)):
                out[t, e] = (i * (i + 1) // 2 if self_interaction
                             else i * (i - 1) // 2) + j
    return out


def fwd_smem_bytes(f: int, d: int, p: int) -> int:
    """Shared memory of one K2 block (``FwdLayout`` in the CUDA source):
    two f32 copies of ``x[b]`` with F padded to whole tiles of 4 rows and
    D to whole quads, two output rows of ``P + 3`` floats padded to a quad
    (a row may start anywhere in a 16-byte group), the tile map and the
    16-entry pair map of each tile."""
    fp, dp, pp = -(-f // 4) * 4, -(-d // 4) * 4, (p + 6) // 4 * 4
    return 4 * (2 * fp * dp + 2 * pp + 17 * len(fwd_tiles(f)))


def bwd_smem_bytes(f: int, d: int, p: int) -> int:
    """Shared memory of one K4 block (``BwdLayout`` in the CUDA source):
    two f32 copies of ``x[b]`` with rows padded to whole quads, two of
    ``dtri[b]`` padded to a quad, and ``S^T`` and its index map with rows
    padded to whole groups of 8."""
    dp, rp, pp = -(-d // 4) * 4, -(-f // 8) * 8, -(-p // 4) * 4
    return 4 * (2 * f * dp + 2 * pp + 2 * f * rp)


def interaction_fwd(x: torch.Tensor, *,
                    self_interaction: bool = False) -> torch.Tensor:
    """``x [B, F, D]`` f32 -> ``[B, P]`` f32, the (strict, or with the
    diagonal when ``self_interaction``) lower triangle of each ``x x^T``
    in ``np.tril_indices`` order."""
    if _build.on_cpu(x):
        return interaction_fwd_plain(x, self_interaction=self_interaction)
    _build.require_cuda("x", x, (torch.float32,), 3)
    b, f, d = x.shape
    p = num_pairs(f, self_interaction)
    _build.require(fwd_smem_bytes(f, d, p) <= MAX_SMEM_BYTES,
                   f"two x[b] of {f}x{d} floats and their maps do not fit "
                   "in shared memory")
    out = torch.empty((b, p), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
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
    _build.require(bwd_smem_bytes(f, d, p) <= MAX_SMEM_BYTES,
                   f"two x[b] of {f}x{d} and their S do not fit in shared "
                   "memory")
    dx = torch.empty_like(x)
    _build.launch(NAME_BWD, "repro_interaction_bwd", x.device, x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], dtri.data_ptr(), dx.data_ptr(),
                  b, f, d, int(self_interaction))
    return dx
