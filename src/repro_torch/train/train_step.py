"""The train step (counterpart of ``repro/train/train_step.py``), on one
device or on every rank of a mesh.

``build_train_step(model, tcfg, mesh=None, mode="gspmd")`` returns
``step(params, opt_state, batch) -> (params, opt_state, {"loss",
"grad_norm"})``: the loss and its gradients by autograd (the embedding
gradients come from K3, the interaction's from K4 on the kernel path), the
dense gradients clipped by their global norm, the dense tower updated by
``tcfg.dense_optimizer`` and the tables by ``tcfg.sparse_optimizer``. With
``tcfg.microbatches > 1`` the batch splits into that many slices whose mean
gradient is accumulated, as the reference's ``scan`` does. The step returns
new tensors: nothing the caller holds is updated in place.

On a mesh (one rank a device, ``launch.mesh``) every rank runs the step on
its data-parallel batch block. Each rank's loss is ``local_mean / n_dev``
(the reference's manual-mode convention, ``repro/train/train_step.py:
12-19``): the MP-sharded tables' gradients are then whole without any
all-reduce (the adjoints of the embedding collectives sum them across
ranks; rows striped over ``"model"`` alone sum over their DP replicas in
f32, as the transpose of ``shard_map``'s replicated input does), and every
replicated parameter (the dense net, the ``dp`` and ``hot`` mega-tables)
takes one all-reduce (sum) over all ranks. ``mode="gspmd"`` sums each
(micro)batch's gradients in f32, as XLA's inserted all-reduce does, and
only then rounds the weight gradients of a bf16 layer
(``layers.deferred_rounding``); ``mode="manual"`` rounds them on each rank,
as the reference's ``shard_map`` does, and casts the accumulated gradients
to ``tcfg.grad_allreduce_dtype`` before the sum and back to f32 after it
(``"bf16"``: the paper's compressed gradient traffic). The loss is summed
the same way in f32, so every rank reports the global batch's mean. One
device (``mesh=None``) is the reference's (1, 1) mesh: the sums are over
one rank, and manual mode's all-reduce only rounds the gradients through
``grad_allreduce_dtype``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.models.recsys import layers
from repro_torch.optim import optimizers as dense_opt_lib
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.optim.sparse import make_sparse
from repro_torch.launch import mesh as meshlib
from repro_torch.tree import flatten, tree_map, unflatten_like

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


def value_and_grad(fn: Callable, params: Dict, *args,
                   deferred: Optional[Dict[str, torch.dtype]] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """``fn(params, *args)`` (a scalar) and its gradient for every leaf of
    ``params``, as a tree of the same keys. Given a ``deferred`` dict, the
    weights that ``layers.rounded_weight`` casts return their gradient
    unrounded, and the dict gets their flat paths and compute dtypes."""
    paths = flatten(params)
    leaves = [v.detach().requires_grad_(True) for _, v in paths]
    keys = [k for k, _ in paths]
    tree = unflatten_like(params, dict(zip(keys, leaves)))
    if deferred is None:
        loss = fn(tree, *args)
    else:
        with layers.deferred_rounding() as rounded:
            loss = fn(tree, *args)
        deferred.update({k: rounded[id(v)] for k, v in zip(keys, leaves)
                         if id(v) in rounded})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten_like(params, dict(zip(keys, grads)))


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


def all_reduce_(t: torch.Tensor, group, dtype: torch.dtype) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks (no group: ``t`` alone),
    reduced in ``dtype`` and returned in f32
    (``psum(g.astype(dtype)).astype(f32)``)."""
    buf = t.detach().to(dtype).contiguous()
    if group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(torch.float32)


def build_train_step(model, tcfg: TrainConfig, mesh=None,
                     mode: str = "gspmd") -> Callable:
    """The train step (see the module docstring): ``step(params,
    opt_state, batch)`` with this rank's shards and replicas and its
    data-parallel batch block (the whole batch on one device)."""
    if mode not in ("gspmd", "manual"):
        raise ValueError(f"mode must be 'gspmd' or 'manual', got {mode!r}")
    dense_opt, sparse_opt = build_optimizers(tcfg)
    n_dev = meshlib.mesh_size(mesh) if mesh is not None else 1
    group = meshlib.axis_group(mesh, meshlib.all_axes(mesh)) \
        if mesh is not None else None
    ar_dtype = torch.bfloat16 if (mode == "manual" and
                                  tcfg.grad_allreduce_dtype == "bf16") \
        else torch.float32
    sharded = model.sharded_keys() if mesh is not None else {}

    def scaled_loss(params, batch):
        # summing over every rank gives the global batch's mean
        return model.loss_fn(params, batch) / n_dev

    def summed(grads, dtype, deferred=None):
        flat = dict(flatten(grads))
        for path, g in flat.items():
            if path not in sharded:
                g = all_reduce_(g, group, dtype)
            elif sharded[path]:
                # rows striped over "model" alone: the DP replicas' sum,
                # in f32 (the transpose of the replicated shard_map input)
                g = all_reduce_(g, meshlib.axis_group(mesh, sharded[path]),
                                torch.float32)
            if deferred and path in deferred:
                g = g.to(deferred[path]).float()
            flat[path] = g
        return unflatten_like(grads, flat)

    def grads_of(params, batch):
        # gspmd: summed over the ranks, then the deferred weights rounded
        if mode == "manual":
            return value_and_grad(scaled_loss, params, batch)
        deferred = {}
        loss, grads = value_and_grad(scaled_loss, params, batch,
                                     deferred=deferred)
        return (all_reduce_(loss, group, torch.float32),
                summed(grads, torch.float32, deferred))

    def train_step(params, opt_state, batch):
        k = tcfg.microbatches
        if k > 1:
            mb = batch["label"].shape[0] // k
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["label"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(k):
                micro = {kk: v[i * mb:(i + 1) * mb]
                         for kk, v in batch.items()}
                mloss, mgrads = grads_of(params, micro)
                grads = tree_map(lambda a, g: a + g / k, grads, mgrads)
                loss = loss + mloss / k
        else:
            loss, grads = grads_of(params, batch)
        if mode == "manual":
            grads = summed(grads, ar_dtype)
            loss = all_reduce_(loss, group, torch.float32)
        with torch.no_grad():
            new_params, new_state, gnorm = _apply_updates(
                params, grads, opt_state, dense_opt, sparse_opt, tcfg)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
