"""K1 and K3: the sum-pooled multi-hot embedding lookup and its adjoint
(``csrc/embedding_lookup.cu``).

Counterparts of ``repro/kernels/embedding_lookup.py::lookup_fwd`` and
``::lookup_bwd``. On CUDA tensors each wrapper launches its hand-written
kernel; on CPU tensors it runs its plain version. There is no fallback
between the two: a CUDA launch that fails raises. K3's kernel adds in the
order of ``lookup_bwd_chunked_plain`` and matches it bit for bit;
``lookup_bwd_plain`` (one ``index_add_``) computes the same function in
another order and is what CPU tensors take.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import LOOKUP_BWD_CHUNK
from repro_torch.kernels.ref import \
    embedding_grad_chunked_ref as lookup_bwd_chunked_plain
from repro_torch.kernels.ref import embedding_grad_ref as lookup_bwd_plain
from repro_torch.kernels.ref import embedding_lookup_ref as lookup_fwd_plain

NAME = "lookup_fwd"
NAME_BWD = "lookup_bwd"
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


def lookup_bwd(table_shape: Sequence[int], rows: torch.Tensor,
               dpooled: torch.Tensor) -> torch.Tensor:
    """``rows [B, H]`` int32 (-1 = pad), ``dpooled [B, D]`` f32 -> the
    dense gradient ``dtable [V, D]`` f32 of :func:`lookup_fwd` for a table
    of ``table_shape``; deterministic (no atomics). One launch on CUDA (a
    chunk pass and a merge pass on the stream), no device-to-host sync."""
    if _build.on_cpu(rows, dpooled):
        return lookup_bwd_plain(table_shape, rows, dpooled)
    _build.require_cuda("rows", rows, (torch.int32,), 2)
    _build.require_cuda("dpooled", dpooled, (torch.float32,), 2)
    v, d = (int(s) for s in table_shape)
    b, h = rows.shape
    _build.require(tuple(dpooled.shape) == (b, d),
                   f"dpooled {tuple(dpooled.shape)} != ({b}, {d})")
    _build.require(rows.device == dpooled.device,
                   f"rows on {rows.device}, dpooled on {dpooled.device}")
    # bookkeeping: the flat ids in stable order and where each came from,
    # and scratch for the runs that cross a chunk edge (sized from B*H
    # alone: nothing comes back to the host)
    ids, order = torch.sort(rows.reshape(-1), stable=True)
    chunks = -(-(b * h) // LOOKUP_BWD_CHUNK)
    partial = torch.empty((2 * max(chunks, 1), d), dtype=torch.float32,
                          device=rows.device)
    out = torch.zeros((v, d), dtype=torch.float32, device=rows.device)
    _build.launch(NAME_BWD, "repro_lookup_bwd", rows.device, ids.data_ptr(),
                  order.data_ptr(), dpooled.data_ptr(), out.data_ptr(),
                  partial.data_ptr(), b * h, h, v, d, LOOKUP_BWD_CHUNK)
    return out
