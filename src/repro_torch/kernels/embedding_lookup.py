"""K1: sum-pooled multi-hot embedding lookup (``csrc/embedding_lookup.cu``).

Counterpart of ``repro/kernels/embedding_lookup.py::lookup_fwd``. On a CUDA
tensor :func:`lookup_fwd` launches the hand-written kernel; on a CPU tensor
it runs the plain version :func:`lookup_fwd_plain`. There is no fallback
between the two: a CUDA launch that fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import embedding_lookup_ref as lookup_fwd_plain

NAME = "lookup_fwd"
TABLE_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def lookup_fwd(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table [V, D]`` (f32/f16/bf16), ``rows [B, H]`` int32 (-1 = pad)
    -> sum-pooled ``[B, D]`` f32; duplicate ids count multiply."""
    if _build.on_cpu(table, rows):
        return lookup_fwd_plain(table, rows)
    _build.require_cuda("table", table, TABLE_DTYPES, 2)
    _build.require_cuda("rows", rows, (torch.int32,), 2)
    _build.require(table.device == rows.device,
                   f"table on {table.device}, rows on {rows.device}")
    b, h = rows.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    _build.launch(NAME, "repro_lookup_fwd", table.device, table.data_ptr(),
                  _build.DTYPE_CODES[table.dtype], rows.data_ptr(),
                  out.data_ptr(), b, h, d)
    return out
