"""K5/K6: the HPS L1 row read (``csrc/hps_gather.cu``).

Counterparts of ``repro/kernels/hps_gather.py::gather_rows`` (K5) and
``::dequant_gather_rows`` (K6). On CUDA tensors the wrappers launch the
hand-written kernel; on CPU tensors they run the plain versions. The
striped multi-device bodies (``sharded_gather_rows`` and its dequant twin)
belong to the multi-GPU slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
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
    _build.require_cuda("payload", payload, PAYLOAD_DTYPES, 2)
    _build.require_cuda("slots", slots, (torch.int32,), 1)
    _build.require(payload.device == slots.device,
                   f"payload on {payload.device}, slots on {slots.device}")
    n, d = slots.shape[0], payload.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=payload.device)
    _build.launch(GATHER, "repro_gather_rows", payload.device,
                  payload.data_ptr(), _build.DTYPE_CODES[payload.dtype],
                  slots.data_ptr(), out.data_ptr(), n, d)
    return out


def dequant_gather_rows(payload: torch.Tensor, scales: torch.Tensor,
                        slots: torch.Tensor) -> torch.Tensor:
    """``payload [C, D]`` (int8/f16), ``scales [C]`` f32, ``slots [N]``
    int32 (-1 = hole) -> ``[N, D]`` f32 ``float(payload[s]) * scales[s]``."""
    if _build.on_cpu(payload, scales, slots):
        return dequant_gather_rows_plain(payload, scales, slots)
    _build.require_cuda("payload", payload, COMPRESSED_DTYPES, 2)
    _build.require_cuda("scales", scales, (torch.float32,), 1)
    _build.require_cuda("slots", slots, (torch.int32,), 1)
    _build.require(payload.device == scales.device == slots.device,
                   "payload, scales and slots must share one device")
    _build.require(scales.shape[0] == payload.shape[0],
                   f"{scales.shape[0]} scales for {payload.shape[0]} rows")
    n, d = slots.shape[0], payload.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=payload.device)
    _build.launch(DEQUANT, "repro_dequant_gather_rows", payload.device,
                  payload.data_ptr(), _build.DTYPE_CODES[payload.dtype],
                  scales.data_ptr(), slots.data_ptr(), out.data_ptr(), n, d)
    return out
