"""Dense optimizers (SGD / Adam / AdamW), counterpart of
``repro/optim/optimizers.py``, in the same f32 arithmetic.

API: ``opt = make(name, TrainConfig)``; ``state = opt.init(params)``;
``params, state = opt.update(grads, state, params, lr_scale)``. Trees are
nested dicts of tensors; ``update`` returns new tensors and leaves the
ones passed in untouched.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def make(name: str, cfg: TrainConfig) -> Optimizer:
    if name == "sgd":
        return _sgd(cfg)
    if name == "adam":
        return _adam(cfg, weight_decay=0.0)
    if name == "adamw":
        return _adam(cfg, weight_decay=cfg.weight_decay)
    raise ValueError(name)


def _step0(params: Dict) -> torch.Tensor:
    """The int32 step counter, on the params' device."""
    first = leaves(params)
    dev = first[0].device if first else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _sgd(cfg: TrainConfig) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params, lr_scale=1.0):
        lr = cfg.learning_rate * lr_scale
        new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new, {"step": state["step"] + 1}

    return Optimizer(init, update)


def _adam(cfg: TrainConfig, weight_decay: float) -> Optimizer:
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(params), "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def update(grads, state, params, lr_scale=1.0):
        step = state["step"] + 1
        lr = cfg.learning_rate * lr_scale
        sf = step.to(torch.float32)
        c1 = 1.0 - b1 ** sf
        c2 = 1.0 - b2 ** sf

        def upd(p, g, mu, nu):
            g = g.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p - lr * u).to(p.dtype), mu, nu

        out = tree_map(upd, params, grads, state["mu"], state["nu"])
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(0), {"step": step, "mu": pick(1), "nu": pick(2)}

    return Optimizer(init, update)


def global_norm(tree: Dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in key order."""
    total = None
    for leaf in leaves(tree):
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def clip_by_global_norm(grads: Dict, max_norm: float
                        ) -> Tuple[Dict, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
