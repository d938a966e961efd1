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
dequant twin, ``_local_stripe_gather``) are :func:`owned_read`: one mesh
entry's owner-mapped pooled read of its block of stripes at GLOBAL slots,
one K5 (K6 with scales) launch for every table of the call;
``ops.mesh_pooled_read`` runs it on each entry: the later entries place
the rows of their stripes, the first pools each row's slots in order.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build, pooled
from repro_torch.kernels.ref import cache_gather_ref as gather_rows_plain
from repro_torch.kernels.ref import (
    dequant_gather_ref as dequant_gather_rows_plain,
)

GATHER = "gather_rows"
DEQUANT = "dequant_gather_rows"
#: the owner-mapped C entries, one table and grouped
GATHER_OWNED = ("repro_gather_rows_mesh", "repro_gather_rows_grouped_mesh")
DEQUANT_OWNED = ("repro_dequant_gather_rows_one_mesh",
                 "repro_dequant_gather_rows_mesh")
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


def owned_read_plain(blocks: Sequence[torch.Tensor],
                     scales: Optional[Sequence[torch.Tensor]],
                     slots: Sequence[torch.Tensor], stripes: int, first: int,
                     rows: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`owned_read`, in the kernel's order:
    without ``out`` the rows of this entry's stripes written into ``rows``
    (nothing else); with ``out`` each row of ``out[:, t]`` the sum over h
    from a zero start of its slots' rows (a hole adds nothing), this
    entry's from its blocks and the others' from ``rows``."""
    col = 0
    for t, (blk, sl) in enumerate(zip(blocks, slots)):
        k, cl, d = blk.shape
        h = sl.shape[1]
        sl = sl.long()
        stripe = sl.remainder(stripes)
        mine = (sl >= 0) & (stripe >= first) & (stripe < first + k)
        local = torch.where(mine, (stripe - first) * cl
                            + torch.div(sl, stripes, rounding_mode="floor"),
                            0)
        own = blk.reshape(k * cl, d)[local].float()
        if scales is not None:
            own = own * scales[t].reshape(k * cl)[local][..., None]
        placed = torch.where(mine[..., None], own, rows[:, col:col + h])
        if out is None:
            rows[:, col:col + h] = placed
        else:
            placed = torch.where((sl >= 0)[..., None], placed, 0.0)
            acc = torch.zeros((sl.shape[0], d), dtype=torch.float32,
                              device=out.device)
            for j in range(h):
                acc = acc + placed[:, j]
            out[:, t] = acc
        col += h
    return out if out is not None else rows


def owned_read(blocks: Sequence[torch.Tensor],
               scales: Optional[Sequence[torch.Tensor]],
               slots: Sequence[torch.Tensor], stripes: int, first: int,
               rows: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cache-mesh entry's read of a striped L1 (the mesh half of K5 /
    K6): ``blocks [k, Cl_t, D]`` one a table (f32 / f16; int8 / f16 with
    ``scales [k, Cl_t]`` f32), the entry's stripes ``first .. first + k -
    1`` of ``stripes``; GLOBAL ``slots [B, H_t]`` int32 (-1 = hole; slot
    ``s`` at stripe ``s % stripes``, row ``s // stripes``); ``rows [B, W,
    D]`` f32, table ``t``'s slot h at column ``H_0 + .. + H_{t-1} + h``.
    Without ``out``: the rows of this entry's stripes placed in ``rows``.
    With ``out [B, T, D]`` f32: ``out[:, t]`` the sum over h of table
    ``t``'s slots' rows, in order, this entry's from its blocks and the
    others' from ``rows`` (``rows`` may be ``out`` where every H_t is 1).
    Returns what it wrote. On CUDA one K5 (K6) launch for every
    :data:`pooled.MAX_TABLES` tables; on the CPU the plain version."""
    if not rows.is_cuda and _build.on_cpu(rows, *blocks, *slots,
                                          *(scales or ())):
        return owned_read_plain(blocks, scales, slots, stripes, first, rows,
                                out)
    if scales is None:
        pooled.launch_owned(GATHER, GATHER_OWNED, blocks, None, slots,
                            PAYLOAD_DTYPES, stripes, first, rows, out)
    else:
        pooled.launch_owned(DEQUANT, DEQUANT_OWNED, blocks, scales, slots,
                            COMPRESSED_DTYPES, stripes, first, rows, out)
    return out if out is not None else rows
