"""Explicit device resolution: ``cuda`` by default, never a silent CPU.

Every entry point of the port takes a ``device`` argument and resolves it
here. ``None`` means ``cuda``; asking for ``cuda`` on a machine without a
card raises instead of falling back to the CPU, so a run that claims to
measure the GPU cannot quietly measure the host.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda"``/``"cuda:N"`` as given.

    Raises ``RuntimeError`` when a CUDA device is requested and
    ``torch.cuda.is_available()`` is false, and ``ValueError`` for any
    device type other than cpu or cuda.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``, copied without a stream
    sync (``non_blocking``): CUDA stages pageable memory before the
    copy call returns, so ``a`` may be dropped at once, and the host does
    not wait for the device work queued before the copy, as a blocking
    copy would (``memcpy_and_sync``: one wait per table and batch on the
    served path)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                         non_blocking=True)


def to_device_many(arrays: Sequence[Optional[np.ndarray]],
                   device: torch.device) -> List[Optional[torch.Tensor]]:
    """Host arrays as tensors on ``device`` through ONE host-to-device
    copy (None stays None): on a card they are packed at 16-byte aligned
    offsets straight into one pinned buffer, copied without a stream
    sync, and each result is a typed view of the one device buffer. One
    copy call a batch instead of one an array: each call gives up the
    interpreter lock and must win it back from the threads probing the
    next tables. The pinned block is reused only once its copy is done
    (the caching host allocator records it). On the CPU each array
    becomes a tensor over its own memory."""
    arrays = [None if a is None else np.ascontiguousarray(a)
              for a in arrays]
    if device.type != "cuda":
        return [None if a is None else torch.from_numpy(a) for a in arrays]
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        if a is not None:
            n += -(-a.nbytes // 16) * 16
    pinned = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=True)
    # a numpy view by address: ``Tensor.numpy`` is a transfer to the
    # hot-path twin (``analysis/hotpath.py``), whatever the device
    packed = np.ctypeslib.as_array((ctypes.c_uint8 * pinned.numel())
                                   .from_address(pinned.data_ptr()))
    for a, o in zip(arrays, offs):
        if a is not None:
            packed[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = pinned.to(device, non_blocking=True)
    return [None if a is None else
            dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize``
    on a card; the CPU runs its work as it is issued, so there is nothing
    to wait for. The stage-synchronous engine's fence between stages
    (the hot-path sanitizer counts it on either device)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
