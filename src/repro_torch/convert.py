"""Parameter interchange with the JAX package's on-disk forms.

The JAX package writes dense parameters as numpy arrays under flat
key-paths (``dense.npz``: ``bottom/w0``, ``top/b4``, ...) and embedding
tables as logical per-table ``[V, D]`` f32 arrays (the PDB files). These
functions turn that form into the port's params (a nested dict of
tensors on a device) and back; the bundle writer uses the reverse
direction, the bundle reader the forward one.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import DeviceLike, resolve_device


def dense_from_flat(flat: Mapping[str, np.ndarray], *,
                    device: DeviceLike = None) -> Dict:
    """``{"bottom/w0": array, ...}`` -> ``{"bottom": {"w0": tensor}}``."""
    dev = resolve_device(device)
    out: Dict = {}
    for key, arr in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(arr, np.float32)).to(dev)
    return out


def dense_to_flat(params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of :func:`dense_from_flat` (arrays as f32 numpy)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(key, v)
            else:
                flat[key] = v.detach().cpu().numpy().astype(np.float32)

    walk("", params)
    return flat


def check_dense(cfg: RecsysConfig, params: Mapping) -> None:
    """Raise ``ValueError`` unless ``params`` has DLRM's dense layout for
    ``cfg`` (``bottom``/``top`` MLPs of the configured widths)."""
    f = cfg.num_tables + 1
    want = {"bottom": [cfg.num_dense_features, *cfg.bottom_mlp],
            "top": [cfg.bottom_mlp[-1] + f * (f - 1) // 2, *cfg.top_mlp]}
    if set(params) != set(want):
        raise ValueError(f"dense params {sorted(params)} != {sorted(want)}")
    for name, dims in want.items():
        for i in range(len(dims) - 1):
            w, b = params[name][f"w{i}"], params[name][f"b{i}"]
            if tuple(w.shape) != (dims[i], dims[i + 1]) or \
                    tuple(b.shape) != (dims[i + 1],):
                raise ValueError(
                    f"{name}/w{i} {tuple(w.shape)}, b{i} {tuple(b.shape)}: "
                    f"want ({dims[i]}, {dims[i + 1]}) and ({dims[i + 1]},)")
        if len(params[name]) != 2 * (len(dims) - 1):
            raise ValueError(f"{name}: {len(params[name])} arrays, want "
                             f"{2 * (len(dims) - 1)}")

