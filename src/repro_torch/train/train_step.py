"""The one-device train step (counterpart of the single-device path of
``repro/train/train_step.py``).

``build_train_step(model, tcfg)`` returns ``step(params, opt_state, batch)
-> (params, opt_state, {"loss", "grad_norm"})``: the loss and its
gradients by autograd (the embedding gradients come from K3, the
interaction's from K4 on the kernel path), the dense gradients clipped by
their global norm, the dense tower updated by ``tcfg.dense_optimizer`` and
the tables by ``tcfg.sparse_optimizer``. With ``tcfg.microbatches > 1`` the
batch splits into that many slices whose mean gradient is accumulated, as
the reference's ``scan`` does. The step returns new tensors: nothing the
caller holds is updated in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.optim import optimizers as dense_opt_lib
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.optim.sparse import make_sparse
from repro_torch.tree import flatten, tree_map, unflatten

SPARSE_KEYS = ("embedding", "wide_embedding")


def is_sparse_key(k: str) -> bool:
    """True for param-tree keys owned by an embedding collection."""
    return k in SPARSE_KEYS or k.startswith("embedding@")


def split_params(params: Dict) -> Tuple[Dict, Dict]:
    sparse = {k: v for k, v in params.items() if is_sparse_key(k)}
    dense = {k: v for k, v in params.items() if not is_sparse_key(k)}
    return sparse, dense


def build_optimizers(tcfg: TrainConfig):
    return (dense_opt_lib.make(tcfg.dense_optimizer, tcfg),
            make_sparse(tcfg.sparse_optimizer, tcfg))


def init_opt_state(params: Dict, tcfg: TrainConfig) -> Dict:
    dense_opt, sparse_opt = build_optimizers(tcfg)
    sparse_p, dense_p = split_params(params)
    return {"dense": dense_opt.init(dense_p),
            "sparse": sparse_opt.init(sparse_p)}


def value_and_grad(fn: Callable, params: Dict, *args
                   ) -> Tuple[torch.Tensor, Dict]:
    """``fn(params, *args)`` (a scalar) and its gradient for every leaf of
    ``params``, as a tree of the same keys."""
    paths = flatten(params)
    leaves = [v.detach().requires_grad_(True) for _, v in paths]
    keys = [k for k, _ in paths]
    loss = fn(unflatten(dict(zip(keys, leaves))), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten(dict(zip(keys, grads)))


def _apply_updates(params, grads, opt_state, dense_opt, sparse_opt, tcfg):
    sparse_p, dense_p = split_params(params)
    sparse_g = {k: grads[k] for k in sparse_p}
    dense_g = {k: grads[k] for k in dense_p}
    dense_g, gnorm = clip_by_global_norm(dense_g, tcfg.grad_clip)
    new_dense, dstate = dense_opt.update(dense_g, opt_state["dense"],
                                         dense_p)
    new_sparse, sstate = sparse_opt.update(sparse_g, opt_state["sparse"],
                                           sparse_p)
    return ({**new_dense, **new_sparse}, {"dense": dstate, "sparse": sstate},
            gnorm)


def _accumulated_grads(model, params: Dict, batch: Dict, k: int):
    b = batch["label"].shape[0]
    mb = b // k
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=batch["label"].device)
    grad_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    for i in range(k):
        micro = {kk: v[i * mb:(i + 1) * mb] for kk, v in batch.items()}
        loss, grads = value_and_grad(model.loss_fn, params, micro)
        grad_acc = tree_map(lambda a, g: a + g / k, grad_acc, grads)
        loss_acc = loss_acc + loss / k
    return loss_acc, grad_acc


def build_train_step(model, tcfg: TrainConfig) -> Callable:
    dense_opt, sparse_opt = build_optimizers(tcfg)

    def train_step(params, opt_state, batch):
        if tcfg.microbatches > 1:
            loss, grads = _accumulated_grads(model, params, batch,
                                             tcfg.microbatches)
        else:
            loss, grads = value_and_grad(model.loss_fn, params, batch)
        with torch.no_grad():
            new_params, new_state, gnorm = _apply_updates(
                params, grads, opt_state, dense_opt, sparse_opt, tcfg)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
