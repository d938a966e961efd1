"""Explicit device resolution: ``cuda`` by default, never a silent CPU.

Every entry point of the port takes a ``device`` argument and resolves it
here. ``None`` means ``cuda``; asking for ``cuda`` on a machine without a
card raises instead of falling back to the CPU, so a run that claims to
measure the GPU cannot quietly measure the host.
"""
from __future__ import annotations

from typing import Optional, Union

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


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize``
    on a card; the CPU runs its work as it is issued, so there is nothing
    to wait for. The stage-synchronous engine's fence between stages
    (the hot-path sanitizer counts it on either device)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
