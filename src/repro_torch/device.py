"""Explicit device resolution: ``cuda`` by default, never a silent CPU.

Every entry point of the port takes a ``device`` argument and resolves it
here. ``None`` means ``cuda``; asking for ``cuda`` on a machine without a
card raises instead of falling back to the CPU, so a run that claims to
measure the GPU cannot quietly measure the host.
"""
from __future__ import annotations

from typing import Optional, Union

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
