"""K5/K6: the HPS L1 row read (``csrc/hps_gather.cu``).

Counterparts of ``repro/kernels/hps_gather.py::gather_rows`` (K5) and
``::dequant_gather_rows`` (K6). On CUDA tensors the wrappers launch the
hand-written kernel; on CPU tensors they run the plain versions. Both are
the pooled read of ``kernels/pooled.py``: K5 (:func:`gather_rows`) its
one-table launch with one slot a row and no scale; K6 the same with
per-row scales, :func:`dequant_gather_grouped` reading and summing every
table of a served int8 batch in one launch and :func:`dequant_gather_rows`
the one-table launch with one slot a row. The
reference's striped multi-device bodies (``sharded_gather_rows`` and its
dequant twin) are ``ops.sharded_cache_gather`` over a cache mesh: one K5
(K6) launch a device over its own stripes, then one sum.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import _build, pooled
from repro_torch.kernels.ref import cache_gather_ref as gather_rows_plain
from repro_torch.kernels.ref import (
    dequant_gather_ref as dequant_gather_rows_plain,
)

GATHER = "gather_rows"
DEQUANT = "dequant_gather_rows"
PAYLOAD_DTYPES = (torch.float32, torch.float16)
COMPRESSED_DTYPES = (torch.float16, torch.int8)


def gather_rows(payload: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``payload [C, D]`` (f32/f16), ``slots [N]`` int32 (-1 = hole)
    -> ``[N, D]`` f32, a zero row for each hole."""
    if _build.on_cpu(payload, slots):
        return gather_rows_plain(payload, slots)
    return pooled.launch_one(GATHER, "repro_gather_rows", payload, None,
                             _one_slot_a_row(slots), PAYLOAD_DTYPES)


def _one_slot_a_row(slots: torch.Tensor) -> torch.Tensor:
    """``slots [N]`` as the pooled read's ``[N, 1]`` block."""
    if slots.dim() != 1:
        raise ValueError(f"slots must be 1-D, got {tuple(slots.shape)}")
    return slots.view(-1, 1)


def dequant_gather_rows(payload: torch.Tensor, scales: torch.Tensor,
                        slots: torch.Tensor) -> torch.Tensor:
    """``payload [C, D]`` (int8/f16), ``scales [C]`` f32, ``slots [N]``
    int32 (-1 = hole) -> ``[N, D]`` f32 ``float(payload[s]) * scales[s]``."""
    if _build.on_cpu(payload, scales, slots):
        return dequant_gather_rows_plain(payload, scales, slots)
    return pooled.launch_one(DEQUANT, "repro_dequant_gather_rows_one",
                             payload, scales, _one_slot_a_row(slots),
                             COMPRESSED_DTYPES)


def dequant_pooled_plain(payload: torch.Tensor, scales: torch.Tensor,
                         slots: torch.Tensor) -> torch.Tensor:
    """The plain pooled dequantizing read: ``slots [B, H]`` -> ``[B, D]``
    f32, the sum over H of :func:`dequant_gather_rows_plain`'s rows."""
    b, h = slots.shape
    rows = dequant_gather_rows_plain(payload, scales, slots.reshape(-1))
    rows = rows.view(b, h, -1)
    return rows[:, 0] if h == 1 else rows.sum(dim=1)


def dequant_gather_grouped_plain(payloads: Sequence[torch.Tensor],
                                 scales: Sequence[torch.Tensor],
                                 slots: Sequence[torch.Tensor]
                                 ) -> torch.Tensor:
    """The plain version of :func:`dequant_gather_grouped`: each table's
    :func:`dequant_pooled_plain`, stacked to ``[B, T, D]``."""
    return torch.stack([dequant_pooled_plain(p, sc, s)
                        for p, sc, s in zip(payloads, scales, slots)], dim=1)


def dequant_gather_grouped(payloads: Sequence[torch.Tensor],
                           scales: Sequence[torch.Tensor],
                           slots: Sequence[torch.Tensor]) -> torch.Tensor:
    """``payloads [C_t, D]`` of one type (int8/f16) with ``scales [C_t]``
    f32, ``slots [B, H_t]`` int32 (-1 = hole) -> ``[B, T, D]`` f32,
    ``out[:, t]`` the sum over H of table ``t``'s dequantized rows: one
    launch for every :data:`pooled.MAX_TABLES` tables on CUDA, the plain
    versions stacked on the CPU (the launch checks that every operand lies
    on the first payload's card)."""
    if payloads and not payloads[0].is_cuda and \
            _build.on_cpu(*payloads, *scales, *slots):
        return dequant_gather_grouped_plain(payloads, scales, slots)
    return pooled.launch(DEQUANT, "repro_dequant_gather_rows", payloads,
                         scales, slots, COMPRESSED_DTYPES)
