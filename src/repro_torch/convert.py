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


def dense_shapes(cfg: RecsysConfig) -> Dict[str, tuple]:
    """Every dense parameter of ``cfg``, ``{key-path: shape}``, by a walk
    of its compiled program (``dense_graph.program_for``): an ``mlp``
    node's ``w{i}``/``b{i}``, a ``cross`` node's ``w{i}``/``b{i}`` of the
    block's width, an ``fm`` node's ``w``/``b`` and the canonical
    first-order term's ``dense_w``/``bias``. The embedding collections'
    keys (``embedding``, ``wide_embedding``, ``embedding@<group>``) are
    not dense."""
    from repro_torch.models.recsys.dense_graph import program_for
    out: Dict[str, tuple] = {}
    for n in program_for(cfg, use_kernels=False).nodes:
        if n.op in ("mlp", "cross", "fm"):
            prefix = "/".join(n.params["p"])
        if n.op == "mlp":
            dims = [n.attrs["in_dim"], *n.attrs["units"]]
            for i in range(len(dims) - 1):
                out[f"{prefix}/w{i}"] = (dims[i], dims[i + 1])
                out[f"{prefix}/b{i}"] = (dims[i + 1],)
        elif n.op == "cross":
            for i in range(n.attrs["num_layers"]):
                out[f"{prefix}/w{i}"] = out[f"{prefix}/b{i}"] = \
                    (n.attrs["in_dim"],)
        elif n.op == "fm":
            out[f"{prefix}/w"], out[f"{prefix}/b"] = \
                (n.attrs["in_dim"],), ()
        elif n.op == "first_order":
            out["/".join(n.params["w"])] = (cfg.num_dense_features,)
            out["/".join(n.params["b"])] = ()
    return out


def check_dense(cfg: RecsysConfig, params: Mapping) -> None:
    """Raise ``ValueError`` unless ``params`` has the dense layout of
    ``cfg``'s recipe (:func:`dense_shapes`): the same key-paths, each of
    its configured shape."""
    want = dense_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in flatten(params)}
    if set(got) != set(want):
        raise ValueError(
            f"{cfg.model} dense params: {sorted(set(got) - set(want))} "
            f"unexpected, {sorted(set(want) - set(got))} missing")
    for k, shape in want.items():
        if got[k] != shape:
            raise ValueError(f"{k}: {got[k]}, want {shape}")


#: The reference ``LMModel.init`` tree, flattened to numpy under its
#: ``/``-joined key-paths (``embed_hot``, ``head``, ``final_norm/scale``,
#: ``groups/0_attn/attn/wq`` ``[layers, D, Hq·Dh]``, a recurrent block's
#: ``groups/0_rglru/rglru/{w_gelu,w_rnn,conv,wa,wx,lam,w_out,norm}``, ...),
#: <-> the port's ``LMModel`` params, dtypes kept: the training state's
#: conversion. An empty subtree (the norms of ``nonparam_ln``) has no
#: leaf, so it comes back absent; the port's norms read an absent
#: ``norm`` as empty.
lm_params_from_flat = state_from_flat
lm_params_to_flat = state_to_flat
