"""Physical storage for the L1 device payload, counterpart of
``repro/core/hps/payload_store.py`` on one device.

``DeviceEmbeddingCache`` resolves ids to logical slots; this module owns
where a slot physically lives. ``shards=1`` is a single ``[C, D]``
payload; ``shards=N`` stripes it as the companion HPS paper (arXiv
2210.08804) does: slot ``s`` lives on stripe ``s % N`` at local row
``s // N`` of an ``[N, Cl, D]`` tensor, padded as the reference pads it,
so both packages hold the same bytes. On one card the stripes are read
through their flat ``[N * Cl, D]`` view with the slots remapped on the
host (``ops.flatten_striped_slots``), so K5, K6 and the grouped pooled
read run unchanged and striping adds no launch.

With a cache ``mesh`` (``launch.mesh.make_cache_mesh``: a list of more
than one device, repeats allowed) the stripes are laid out across its
devices as the reference lays them over its cache axis: stripe ``i`` on
device ``i * size // N``, each device holding the ``[k, Cl, D]`` block of
its stripes (and the int8 scales of their rows). Reads keep the GLOBAL
slots: each device reads its own stripes with K5 / K6, the others' slots
set to -1, and the partial rows meet on the first device in one sum
(``ops.sharded_cache_gather``).

Payload precision is a storage knob: ``"f32"`` (bit-exact), ``"f16"``
(half the bytes) or ``"int8"`` (per-row absmax quantization plus an f32
scale per row, striped with its row). Rows quantize on the host with the
reference's numpy code, so both packages store identical bytes; reads
dequantize inside the gather kernel (K6).

Snapshots are immutable by CLONE-ON-WRITE: ``scatter`` builds a new
payload tensor (a device copy of the old one with the new rows written)
and rebinds the store to it. It never writes into a tensor a snapshot may
hold, so a plan that bound a snapshot before a later scatter still gathers
exactly the rows it resolved, even while another thread scatters. The old
tensor is freed when its last snapshot goes; kernels already queued on it
are ordered before that reuse by the CUDA caching allocator on the same
stream. The cost is one payload copy per scatter (one per table per query
with misses, and per refresh chunk).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

PAYLOAD_DTYPES = ("f32", "f16", "int8")

_STORAGE = {"f32": torch.float32, "f16": torch.float16, "int8": torch.int8}


def _pad_first(a: np.ndarray, m: int, dtype=None) -> np.ndarray:
    """``a`` extended to ``m`` entries along its first axis by repeating
    its first entry."""
    out = np.empty((m,) + a.shape[1:], a.dtype if dtype is None else dtype)
    out[:len(a)] = a
    out[len(a):] = a[0]
    return out


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def row_bytes(dim: int, payload_dtype: str = "f32") -> int:
    """Device bytes one resident row costs in a given storage mode (int8
    includes its 4-byte per-row f32 scale)."""
    if payload_dtype == "f32":
        return 4 * dim
    if payload_dtype == "f16":
        return 2 * dim
    if payload_dtype == "int8":
        return dim + 4
    raise ValueError(f"unknown payload_dtype {payload_dtype!r}; "
                     f"expected one of {PAYLOAD_DTYPES}")


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
    """Physical slot storage: a single ``[C, D]`` payload (``shards=1``)
    or ``[N, Cl, D]`` stripes (``shards=N``), on one device or laid out
    over a cache ``mesh``, in one of the ``PAYLOAD_DTYPES`` storage modes
    (plus ``[C]`` or ``[N, Cl]`` f32 scales for int8)."""

    def __init__(self, capacity: int, dim: int, *, shards: int = 1,
                 mesh=None, payload_dtype: str = "f32",
                 device: DeviceLike = None):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards > capacity:
            raise ValueError(
                f"shards={shards} exceeds capacity={capacity}")
        if payload_dtype not in _STORAGE:
            raise ValueError(f"unknown payload_dtype {payload_dtype!r}; "
                             f"expected one of {PAYLOAD_DTYPES}")
        if mesh is not None and len(mesh) > 1:
            if shards % len(mesh):
                raise ValueError(
                    f"shards={shards} does not tile a cache mesh of "
                    f"{len(mesh)} devices")
            mesh = [resolve_device(d) for d in mesh]
            if device is not None and resolve_device(device) != mesh[0]:
                raise ValueError(f"a cache mesh starting at {mesh[0]} "
                                 f"serves on it, not on {device}")
            device = mesh[0]
        else:
            mesh = None                  # one device: the flat view
        self.capacity = capacity
        self.dim = dim
        self.shards = shards
        self.mesh = mesh
        self.payload_dtype = payload_dtype
        self.device = resolve_device(device)
        # rows padded to the reference's gather tile, so both stores have
        # the same shape: [C, D] for one stripe, [N, Cl, D] for N
        local_cap = -(-capacity // shards)
        bc = min(512, _round_up(local_cap, 8))
        self.local_rows = _round_up(local_cap, bc)
        self.phys_rows = shards * self.local_rows
        need = self.phys_rows * row_bytes(dim, payload_dtype) \
            // (len(mesh) if mesh else 1)
        if self.device.type == "cuda":
            have = torch.cuda.get_device_properties(self.device).total_memory
            if need > have:
                raise ValueError(
                    f"an L1 of {need} bytes a device, more than the {have} "
                    "bytes of one card: stripe it across devices "
                    "(cache_mesh=launch.mesh.make_cache_mesh(shards))")
        shape = ((self.phys_rows,) if shards == 1
                 else (shards, self.local_rows))
        if mesh is not None:             # [k, Cl(, D)] a device
            shape = (shards // len(mesh), self.local_rows)
        devices = mesh or [self.device]
        self._payload = tuple(torch.zeros(shape + (dim,),
                                          dtype=_STORAGE[payload_dtype],
                                          device=d) for d in devices)
        self._scales = (tuple(torch.ones(shape, dtype=torch.float32,
                                         device=d) for d in devices)
                        if payload_dtype == "int8" else None)
        if mesh is None:
            self._payload = self._payload[0]
            self._scales = None if self._scales is None else self._scales[0]

    def _flat(self, slots: np.ndarray) -> np.ndarray:
        """Logical slots as rows of the flat ``[N * Cl]`` row space (slot
        ``s`` at stripe ``s % N``, local row ``s // N``; -1 holes kept)."""
        if self.shards == 1:
            return slots
        return np.where(slots >= 0, (slots % self.shards) * self.local_rows
                        + slots // self.shards, -1).astype(slots.dtype)

    def flat_rows(self, slots: np.ndarray) -> np.ndarray:
        """Logical slots as the reads take them, on the host: rows of the
        flat payload view on one device, the GLOBAL slots themselves on a
        cache mesh."""
        return slots if self.mesh is not None else self._flat(slots)

    def prepare(self, slots: np.ndarray, rows: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """The host half of a scatter: ``(flat rows int64, stored rows,
        scales or None)``, the rows quantized here. Slot counts are padded
        to a multiple of 64 by repeating the first slot, as the reference
        does (idempotent: the repeated writes carry the same row)."""
        rows, scales = quantize_rows(np.asarray(rows), self.payload_dtype)
        n = len(slots)
        m = _round_up(n, 64)
        if m > n:
            slots, rows, scales = (_pad_first(slots, m, np.int64),
                                   _pad_first(rows, m),
                                   None if scales is None
                                   else _pad_first(scales, m))
        return (self._flat(np.asarray(slots, np.int64)), rows, scales)

    def write(self, idx: torch.Tensor, rows: torch.Tensor,
              scales: Optional[torch.Tensor]) -> None:
        """The device half: ``prepare``'s arrays, on this store's device,
        written into a copy of the payload, which the store rebinds to."""
        if self.mesh is not None:
            self._payload = self._write_blocks(self._payload, idx, rows)
            if scales is not None:
                self._scales = self._write_blocks(self._scales, idx, scales)
            return
        payload = self._payload.clone()
        payload.view(-1, self.dim).index_copy_(0, idx, rows)
        if scales is not None:
            new_scales = self._scales.clone()
            new_scales.view(-1).index_copy_(0, idx, scales)
            self._scales = new_scales
        self._payload = payload

    def _write_blocks(self, blocks: tuple, idx: torch.Tensor,
                      vals: torch.Tensor) -> tuple:
        """Copies of the per-device ``blocks`` with ``vals`` written at the
        flat rows ``idx``: each block takes the rows in its range, the
        others land in a spare row that is dropped (no host sync)."""
        out, lo = [], 0
        for block in blocks:
            n = block.shape[0] * block.shape[1]
            dev = block.device
            local = idx.to(dev) - lo
            local = torch.where((local >= 0) & (local < n), local, n)
            flat = torch.cat([block.reshape(n, *block.shape[2:]),
                              block.new_zeros((1,) + block.shape[2:])])
            flat.index_copy_(0, local, vals.to(dev))
            out.append(flat[:n].view(block.shape))
            lo += n
        return tuple(out)

    def scatter(self, slots: np.ndarray, rows: np.ndarray) -> None:
        """Write ``rows`` (f32, quantized here) at ``slots`` into a copy of
        the payload and rebind to it: ``prepare``, one copy to the
        device, ``write``."""
        self.write(*devmod.to_device_many(self.prepare(slots, rows),
                                          self.device))

    def snapshot(self):
        """The current ``(payload, scales)`` pair (``[C, D]`` or
        ``[N, Cl, D]``, on a cache mesh a tuple of per-device ``[k, Cl,
        D]`` blocks; ``scales`` is None outside int8). No later scatter
        writes into these tensors."""
        return (self._payload, self._scales)

    def gather(self, snapshot, slots) -> torch.Tensor:
        """Logical ``slots [n]`` (-1 = hole: an int32 tensor on this
        store's device, or numpy, remapped on the host) -> ``[n, D]`` f32
        rows off a snapshot of this store (K5, or K6 when compressed)."""
        payload, scales = snapshot
        if self.shards > 1:
            return ops.sharded_cache_gather(payload, slots, scales=scales,
                                            mesh=self.mesh)
        return ops.cache_gather(payload, ops.slot_tensor(slots, self.device),
                                scales=scales)
