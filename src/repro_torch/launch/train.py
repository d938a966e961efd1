"""Training launcher, counterpart of ``repro/launch/train.py``, and the
LM train steps it runs.

  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-criteo \\
      --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-criteo \\
      --steps 200 --batch 4096 --ckpt-dir /tmp/ckpt   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
      --steps 5 --batch 1 --seq 4096          # on the card, full width
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-9b --smoke --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch dlrm-criteo --smoke --device cpu --mesh 2x2 --mode manual \\
      --grad-ar-dtype bf16                    # four gloo ranks
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --smoke --device cpu --mesh 2x2

A recsys recipe (``RECSYS_RECIPES``) goes through the graph API as in the
reference: its module's ``build_model(smoke=--smoke, solver=Solver(batch,
lr, grad_allreduce_dtype, mode, comm, ckpt_interval))``, ``compile``,
``summary`` and ``fit`` with async checkpoints under ``--ckpt-dir`` every
``--ckpt-interval`` steps; a second run with more ``--steps`` resumes from
the newest checkpoint there. An LM arch trains as the reference's LM
branch: the model of ``--arch`` (reduced by ``--smoke``) from seed-0
weights, a batch of tokens drawn uniformly from the vocabulary each step
(numpy, seed 0), and plain SGD, ``p - lr * g``. Like the reference's, the
batch holds ``tokens`` only, so the encoder-decoder (seamless, which also
needs ``frames``) and the vision prefix (pixtral, ``patches``) raise the
reference's ``KeyError``; ``lm_value_and_grad`` and ``lm_sgd_step_``
take a whole batch for them.

A recipe or an LM arch trains on a mesh as the reference's does: run one
process a device under ``torchrun --nproc-per-node N`` (the launcher joins
the process group torchrun describes: NCCL on cards, gloo with ``--device
cpu``, each rank on card ``LOCAL_RANK``); ``--mesh RxC`` lays the ranks
out as a ``("data", "model")`` mesh, ``auto`` as ``(N, 1)`` (no mesh on
one process). A recipe's ``--mode``, ``--comm`` and ``--grad-ar-dtype``
(bf16: the compressed gradient all-reduce of manual mode) go into the
``Solver``. An LM arch's model spreads over the mesh (``LMModel(cfg,
mesh)``: its token table striped over ``"model"``, the head and the loss
vocab-parallel, the experts over ``"model"``); every rank draws the same
global batch and trains on its data-parallel block, and the SGD step
updates each rank's own shards. Rank 0 logs and writes the checkpoints.

Unlike the reference, one device does not imply the smoke reduction: the
card trains a recipe or an LM at full width. Everything runs on ``cuda``
unless ``--device cpu``. For an LM arch ``--mode``, ``--comm``,
``--grad-ar-dtype`` and ``--ckpt-dir`` are taken and ignored, as the
reference's LM branch does.
"""
from __future__ import annotations

import argparse
import importlib
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.registry import (
    LM_ARCHS, RECSYS_RECIPES, reduce_for_smoke)
from repro_torch.models.lm.backbone import LMModel
from repro_torch.launch import mesh as meshlib
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import flatten, tree_map


def lm_value_and_grad(model: LMModel, params: Dict,
                      tokens: Union[torch.Tensor, Dict]
                      ) -> Tuple[torch.Tensor, Dict]:
    """``(loss, grads)`` of ``model.train_loss`` at ``params`` on
    ``tokens`` (a ``[B, S]`` tensor, or a whole batch dict: ``tokens``
    with ``frames`` or ``patches``); ``grads`` has ``params``' tree.
    ``params`` are left as they are (autograd runs on detached aliases of
    them). On a mesh: this rank's data block and parameters, the global
    loss, and the gradients of this rank's parameters summed over the
    data axes (``LMModel.reduce_grads``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    loss = model.train_loss(live, batch)
    leaves = [t for _, t in flatten(live)]
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), model.reduce_grads(
        tree_map(lambda t: grads[id(t)], live))


def lm_train_step(model: LMModel, opt: Optimizer) -> Callable:
    """The counterpart of the train branch of
    ``repro/launch/specs.py::lm_step_fn``: ``(params, opt_state, tokens)
    -> (params, opt_state, loss)`` with any ``optimizers.make`` optimizer;
    new trees, the ones passed in untouched."""
    def step(params, opt_state, tokens):
        loss, grads = lm_value_and_grad(model, params, tokens)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def lm_sgd_step_(model: LMModel, params: Dict,
                 tokens: Union[torch.Tensor, Dict],
                 lr: float) -> torch.Tensor:
    """One SGD step, ``p - lr * g``, written into ``params`` in place; the
    values of ``optimizers.make("sgd")`` without its second copy of the
    parameters (16.76 GB for minitron-4b). Returns the loss before it."""
    loss, grads = lm_value_and_grad(model, params, tokens)
    with torch.no_grad():
        for (_, p), (_, g) in zip(flatten(params), flatten(grads)):
            p.sub_(g.to(p.dtype).mul_(lr))
    return loss


def mesh_shape_arg(mesh: str):
    """``--mesh``: ``auto`` -> None (the Solver's default), ``RxC`` ->
    ``(R, C)``."""
    if mesh == "auto":
        return None
    try:
        r, c = (int(x) for x in mesh.split("x"))
    except ValueError:
        raise ValueError(f"--mesh must be 'auto' or 'RxC', got {mesh!r}")
    return (r, c)


def join_process_group(device) -> bool:
    """Join the process group ``torchrun`` describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``...): NCCL on cards, each
    rank on card ``LOCAL_RANK``, gloo on the CPU. Nothing without it, or
    when a group is already up. True when this call started the group."""
    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    on_cpu = device is not None and str(device).startswith("cpu")
    if not on_cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if on_cpu else "nccl")
    return True


def leave_process_group() -> None:
    """Wait for every rank, then tear the group down (a rank that exits
    with the group up may abort in its destructor while another still
    talks to it)."""
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def train_recipe(args) -> List[Dict]:
    """The recsys branch: build, compile, summarise and fit the recipe of
    ``args.arch``; returns the trainer's history of this run's steps."""
    from repro_torch.api import Solver
    recipe = importlib.import_module(RECSYS_RECIPES[args.arch])
    joined = join_process_group(args.device)
    solver = Solver(batch_size=args.batch, lr=args.lr,
                    grad_allreduce_dtype=args.grad_ar_dtype,
                    mode=args.mode, comm=args.comm,
                    mesh_shape=mesh_shape_arg(args.mesh),
                    ckpt_interval=args.ckpt_interval)
    model = recipe.build_model(smoke=args.smoke, solver=solver)
    model.compile(device=args.device)
    if model._lead():
        if model.mesh is not None:
            from repro_torch.launch import mesh as meshlib
            print(f"mesh: {meshlib.mesh_shape(model.mesh)} over "
                  f"{meshlib.world_size()} ranks")
        model.summary()
    hist = model.fit(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     log_every=args.log_every)
    losses = [h["loss"] for h in hist]
    lead = model._lead()
    if joined:
        leave_process_group()
    if not lead:
        return hist
    if losses:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{model.stragglers} stragglers flagged")
    else:
        print(f"done: nothing to run, the checkpoint is at step "
              f"{args.steps - 1} or later")
    return hist


def main(argv: Optional[Sequence[str]] = None
         ) -> Union[List[float], List[Dict]]:
    """Train; returns an LM's loss of every step, or a recipe's history
    (``{"step", "loss", "time"}`` a step this run took)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=sorted(LM_ARCHS) + sorted(RECSYS_RECIPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--grad-ar-dtype", default="f32",
                    choices=["f32", "bf16"],
                    help="bf16 = compressed gradient all-reduce (manual "
                         "mode)")
    ap.add_argument("--mode", default="gspmd", choices=["gspmd", "manual"])
    ap.add_argument("--comm", default="auto",
                    choices=["auto", "allgather_rs", "all_to_all"])
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (N x 1 over the torchrun ranks) | 'RxC'")
    args = ap.parse_args(argv)
    if args.arch in RECSYS_RECIPES:
        return train_recipe(args)
    return train_lm(args)


def train_lm(args) -> List[float]:
    """The LM branch: the model of ``args.arch`` (reduced by ``--smoke``)
    from seed-0 weights, on the mesh ``--mesh`` asks for (none on one
    process), SGD on uniform random tokens; returns the loss of every
    step."""
    cfg = LM_ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    joined = join_process_group(args.device)
    mesh = meshlib.auto_mesh(mesh_shape_arg(args.mesh))
    if mesh is not None and not meshlib.in_mesh(mesh):
        # a rank past a mesh smaller than the group does no work on it
        if joined:
            leave_process_group()
        return []
    lead = mesh is None or meshlib.axis_index(
        mesh, meshlib.all_axes(mesh)) == 0
    model = LMModel(cfg, mesh, device=args.device,
                    loss_chunk=min(args.seq, 128))
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    if lead:
        where = "" if mesh is None else \
            f" on the mesh {meshlib.mesh_shape(mesh)}"
        print(f"arch {cfg.name}: embed_mode={model.embed_mode} "
              f"attn_partition={model.attn_partition} on "
              f"{model.device}{where}")
    rng = np.random.default_rng(0)
    losses = []
    for i in range(args.steps):
        tokens = model.data_block(torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.seq)))).to(model.device)
        losses.append(float(lm_sgd_step_(model, params, tokens, args.lr)))
        if lead and i % args.log_every == 0:
            print(f"step {i:4d} loss={losses[-1]:.4f}")
    if joined:
        leave_process_group()
    if lead:
        print(f"done: final loss {losses[-1]:.4f} "
              f"(ln V = {np.log(cfg.vocab_size):.2f})")
    return losses


if __name__ == "__main__":
    main()
