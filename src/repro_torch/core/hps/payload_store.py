"""Physical storage for the L1 device payload (counterpart of
``repro/core/hps/payload_store.py``, single-payload case).

``DeviceEmbeddingCache`` resolves ids to logical slots; this module owns
the device tensor the slots index. Payload precision is a storage knob:
``"f32"`` (bit-exact), ``"f16"`` (half the bytes) or ``"int8"`` (per-row
absmax quantization plus an f32 scale per row). Rows quantize on the host
with the reference's numpy code, so both packages store identical bytes;
reads dequantize inside the gather kernel (K6).

Snapshots are immutable by CLONE-ON-WRITE: ``scatter`` builds a new
payload tensor (a device copy of the old one with the new rows written)
and rebinds the store to it. It never writes into a tensor a snapshot may
hold, so a plan that bound a snapshot before a later scatter still gathers
exactly the rows it resolved, even while another thread scatters. The old
tensor is freed when its last snapshot goes; kernels already queued on it
are ordered before that reuse by the CUDA caching allocator on the same
stream. The cost is one payload copy per scatter (one per table per query
with misses).

Only ``shards=1`` is ported; the striped payload belongs to the multi-GPU
slice (ROADMAP item "Multi-GPU").
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

PAYLOAD_DTYPES = ("f32", "f16", "int8")

_STORAGE = {"f32": torch.float32, "f16": torch.float16, "int8": torch.int8}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def quantize_rows(rows: np.ndarray, payload_dtype: str
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Host-side insert-path quantization, the reference's numpy code:
    ``rows [n, D]`` f32 -> ``(stored_rows, scales_or_None)``.

    int8: ``scale = max|row| / 127`` (1.0 for all-zero rows), ``np.rint``
    (half to even), clip to [-127, 127]. f16 is a plain downcast.
    """
    rows = np.asarray(rows, np.float32)
    if payload_dtype == "f32":
        return rows, None
    if payload_dtype == "f16":
        return rows.astype(np.float16), None
    if payload_dtype == "int8":
        absmax = np.abs(rows).max(axis=1)
        scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(rows / scales[:, None]), -127, 127)
        return q.astype(np.int8), scales
    raise ValueError(f"unknown payload_dtype {payload_dtype!r}; "
                     f"expected one of {PAYLOAD_DTYPES}")


class ShardedPayloadStore:
    """A single ``[C, D]`` device payload in one of the
    ``PAYLOAD_DTYPES`` storage modes (plus ``[C]`` f32 scales for int8)."""

    def __init__(self, capacity: int, dim: int, *, shards: int = 1,
                 payload_dtype: str = "f32", device: DeviceLike = None):
        if shards != 1:
            raise NotImplementedError(
                "the striped L1 payload (cache_shards > 1) is ported with "
                "the ROADMAP item 'Multi-GPU'")
        if payload_dtype not in _STORAGE:
            raise ValueError(f"unknown payload_dtype {payload_dtype!r}; "
                             f"expected one of {PAYLOAD_DTYPES}")
        self.capacity = capacity
        self.dim = dim
        self.shards = 1
        self.payload_dtype = payload_dtype
        self.device = resolve_device(device)
        # physical rows padded as the reference pads them to its gather
        # tile, so both stores have the same shape
        bc = min(512, _round_up(capacity, 8))
        self.phys_rows = _round_up(capacity, bc)
        self._payload = torch.zeros((self.phys_rows, dim),
                                    dtype=_STORAGE[payload_dtype],
                                    device=self.device)
        self._scales = (torch.ones((self.phys_rows,), dtype=torch.float32,
                                   device=self.device)
                        if payload_dtype == "int8" else None)

    def scatter(self, slots: np.ndarray, rows: np.ndarray) -> None:
        """Write ``rows`` (f32, quantized here) at ``slots`` into a copy of
        the payload and rebind to it. Slot counts are padded to a multiple
        of 64 by repeating the first slot, as the reference does
        (idempotent: the repeated writes carry the same row)."""
        rows, scales = quantize_rows(np.asarray(rows), self.payload_dtype)
        pad = _round_up(len(slots), 64) - len(slots)
        if pad:
            slots = np.concatenate([slots, np.full(pad, slots[0])])
            rows = np.concatenate(
                [rows, np.broadcast_to(rows[:1], (pad, rows.shape[1]))])
            if scales is not None:
                scales = np.concatenate(
                    [scales, np.broadcast_to(scales[:1], (pad,))])
        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)
        payload = self._payload.clone()
        payload.index_copy_(0, idx, torch.from_numpy(
            np.ascontiguousarray(rows)).to(self.device))
        if scales is not None:
            new_scales = self._scales.clone()
            new_scales.index_copy_(0, idx, torch.from_numpy(
                np.ascontiguousarray(scales)).to(self.device))
            self._scales = new_scales
        self._payload = payload

    def snapshot(self):
        """The current ``(payload, scales)`` pair (``scales`` is None
        outside int8). No later scatter writes into these tensors."""
        return (self._payload, self._scales)

    def gather(self, snapshot, slots: torch.Tensor) -> torch.Tensor:
        """Logical ``slots [n]`` int32 (-1 = hole) -> ``[n, D]`` f32 rows
        off a snapshot of this store (K5, or K6 when compressed)."""
        payload, scales = snapshot
        return ops.cache_gather(payload, slots, scales=scales)
