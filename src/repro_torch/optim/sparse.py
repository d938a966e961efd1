"""Sparse (embedding) optimizers, counterpart of ``repro/optim/sparse.py``:
row-wise AdaGrad, HugeCTR's default.

State is one accumulator scalar per row (V floats for a ``[V, D]`` table).
The update runs over every row of the dense gradient, as the reference's
does: a row with zero gradient keeps its value and accumulator exactly
(``a + 0``, ``p - scale * 0``). A sparse update over only the touched rows
is a later optimization.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.optim.optimizers import Optimizer, make
from repro_torch.tree import tree_map


def rowwise_adagrad(cfg: TrainConfig,
                    initial_accumulator: float = 0.0) -> Optimizer:
    eps = 1e-10

    def init(params):
        def acc(p):
            if p.dim() == 2:
                return torch.full((p.shape[0],), initial_accumulator,
                                  dtype=torch.float32, device=p.device)
            return torch.zeros(p.shape[:1], dtype=torch.float32,
                               device=p.device)
        return {"acc": tree_map(acc, params)}

    def update(grads, state, params, lr_scale=1.0):
        lr = cfg.learning_rate * lr_scale

        def upd(p, g, a):
            g = g.float()
            a = a + torch.mean(g * g, dim=tuple(range(1, g.dim())))
            scale = lr / (torch.sqrt(a) + eps)
            new_p = p.float() - scale[:, None] * g \
                if g.dim() == 2 else p - scale * g
            return new_p.to(p.dtype), a

        out = tree_map(upd, params, grads, state["acc"])
        return (tree_map(lambda o: o[0], out),
                {"acc": tree_map(lambda o: o[1], out)})

    return Optimizer(init, update)


def make_sparse(name: str, cfg: TrainConfig) -> Optimizer:
    if name == "rowwise_adagrad":
        return rowwise_adagrad(cfg)
    if name == "sgd":
        return make("sgd", cfg)
    raise ValueError(name)
