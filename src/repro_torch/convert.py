"""Parameter and training-state interchange with the JAX package's forms.

The JAX package writes dense parameters as numpy arrays under flat
key-paths (``dense.npz``: ``bottom/w0``, ``top/b4``, ...), embedding
tables as logical per-table ``[V, D]`` f32 arrays (the PDB files), and a
training state as the same flat key-paths over ``{"params", "opt"}`` (the
checkpoint). These functions turn those forms into the port's trees (nested
dicts of tensors on a device) and back: the bundle writer uses the reverse
direction, the bundle reader the forward one, and the parity tests start
both frameworks from one JAX-exported training state. The LM side's
parameters move the same way (``lm_params_from_flat``/``lm_params_to_flat``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import flatten, unflatten


def dense_from_flat(flat: Mapping[str, np.ndarray], *,
                    device: DeviceLike = None) -> Dict:
    """``{"bottom/w0": array, ...}`` -> ``{"bottom": {"w0": tensor}}``."""
    return state_from_flat({k: np.asarray(v, np.float32)
                            for k, v in flat.items()}, device=device)


def dense_to_flat(params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of :func:`dense_from_flat` (arrays as f32 numpy)."""
    return {k: v.astype(np.float32)
            for k, v in state_to_flat(params).items()}


def state_from_flat(flat: Mapping[str, np.ndarray], *,
                    device: DeviceLike = None) -> Dict:
    """A whole training state in the reference's flat form -> a nested
    dict of tensors on ``device``, dtypes kept.

    ``flat`` maps key-paths to arrays as ``repro/train/checkpoint.py``
    flattens ``{"params": export_logical_params(...), "opt": opt_state}``:
    ``params/embedding/dp``, ``params/bottom/w0``, ``opt/dense/mu/top/b1``,
    ``opt/dense/step``, ``opt/sparse/acc/embedding/dist``, ... Pass the
    ``params`` subtree through ``import_logical_params`` to train on it.
    """
    dev = resolve_device(device)
    return unflatten({k: torch.from_numpy(np.array(v)).to(dev)
                      for k, v in flat.items()})


def state_to_flat(tree: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_from_flat`: numpy arrays under the
    reference's key-paths (sorted keys joined by ``/``), dtypes kept.
    Leaves may be tensors or arrays."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in flatten(tree)}


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


#: The reference ``LMModel.init`` tree, flattened to numpy under its
#: ``/``-joined key-paths (``embed_hot``, ``head``, ``final_norm/scale``,
#: ``groups/0_attn/attn/wq`` ``[layers, D, Hq·Dh]``, ...), <-> the port's
#: ``LMModel`` params, dtypes kept: the training state's conversion. An
#: empty subtree (the norms of ``nonparam_ln``) has no leaf, so it comes
#: back absent; the port's norms read an absent ``norm`` as empty.
lm_params_from_flat = state_from_flat
lm_params_to_flat = state_to_flat
