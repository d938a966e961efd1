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

A recsys recipe (``RECSYS_RECIPES``) goes through the graph API as in the
reference: its module's ``build_model(smoke=--smoke, solver=Solver(batch,
lr, grad_allreduce_dtype, mode, comm, ckpt_interval))``, ``compile``,
``summary`` and ``fit`` with async checkpoints under ``--ckpt-dir`` every
``--ckpt-interval`` steps; a second run with more ``--steps`` resumes from
the newest checkpoint there. An LM arch trains as the reference's LM
branch: the model of ``--arch`` (reduced by ``--smoke``) from seed-0
weights, a batch of tokens drawn uniformly from the vocabulary each step
(numpy, seed 0), and plain SGD, ``p - lr * g``.

Unlike the reference, one device does not imply the smoke reduction: the
card trains a recipe or an LM at full width. Everything runs on ``cuda``
unless ``--device cpu``. A mesh other than ``auto``, ``--mode manual``,
a ``--comm`` other than ``auto`` and ``--grad-ar-dtype bf16`` (the
compressed gradient all-reduce) raise ``NotImplementedError`` naming
ROADMAP queue 1 item 4, and ``--ckpt-dir`` for an LM arch names its item
7 entry (the reference's LM branch takes the flag and ignores it).
"""
from __future__ import annotations

import argparse
import importlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.registry import (
    LM_ARCHS, RECSYS_RECIPES, reduce_for_smoke)
from repro_torch.models.lm.backbone import LMModel
from repro_torch.optim.optimizers import Optimizer
from repro_torch.roadmap import LM_CKPT, MULTI_DEVICE, not_ported
from repro_torch.tree import flatten, tree_map


def lm_value_and_grad(model: LMModel, params: Dict, tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict]:
    """``(loss, grads)`` of ``model.train_loss`` at ``params``; ``grads``
    has ``params``' tree. ``params`` are left as they are (autograd runs
    on detached aliases of them)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.train_loss(live, {"tokens": tokens})
    leaves = [t for _, t in flatten(live)]
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda t: grads[id(t)], live)


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


def lm_sgd_step_(model: LMModel, params: Dict, tokens: torch.Tensor,
                 lr: float) -> torch.Tensor:
    """One SGD step, ``p - lr * g``, written into ``params`` in place; the
    values of ``optimizers.make("sgd")`` without its second copy of the
    parameters (16.76 GB for minitron-4b). Returns the loss before it."""
    loss, grads = lm_value_and_grad(model, params, tokens)
    with torch.no_grad():
        for (_, p), (_, g) in zip(flatten(params), flatten(grads)):
            p.sub_(g.to(p.dtype).mul_(lr))
    return loss


def _refuse(args) -> None:
    """Raise for what the port leaves out, naming its ROADMAP item."""
    if args.mesh != "auto":
        raise not_ported(f"--mesh {args.mesh}", MULTI_DEVICE)
    if args.mode != "gspmd":
        raise not_ported(f"--mode {args.mode}", MULTI_DEVICE)
    if args.comm != "auto":
        raise not_ported(f"--comm {args.comm}", MULTI_DEVICE)
    if args.grad_ar_dtype != "f32":
        raise not_ported(f"--grad-ar-dtype {args.grad_ar_dtype}",
                         MULTI_DEVICE)
    if args.ckpt_dir is not None and args.arch in LM_ARCHS:
        raise not_ported("--ckpt-dir for an LM arch", LM_CKPT)


def train_recipe(args) -> List[Dict]:
    """The recsys branch: build, compile, summarise and fit the recipe of
    ``args.arch``; returns the trainer's history of this run's steps."""
    from repro_torch.api import Solver
    recipe = importlib.import_module(RECSYS_RECIPES[args.arch])
    solver = Solver(batch_size=args.batch, lr=args.lr,
                    grad_allreduce_dtype=args.grad_ar_dtype,
                    mode=args.mode, comm=args.comm,
                    ckpt_interval=args.ckpt_interval)
    model = recipe.build_model(smoke=args.smoke, solver=solver)
    model.compile(device=args.device)
    model.summary()
    hist = model.fit(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     log_every=args.log_every)
    losses = [h["loss"] for h in hist]
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
                    help="bf16 = compressed gradient all-reduce, a mesh "
                         "knob: one device has no all-reduce, so bf16 "
                         "raises")
    ap.add_argument("--mode", default="gspmd", choices=["gspmd", "manual"])
    ap.add_argument("--comm", default="auto",
                    choices=["auto", "allgather_rs", "all_to_all"])
    ap.add_argument("--mesh", default="auto")
    args = ap.parse_args(argv)
    _refuse(args)
    if args.arch in RECSYS_RECIPES:
        return train_recipe(args)

    cfg = LM_ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    model = LMModel(cfg, device=args.device,
                    loss_chunk=min(args.seq, 128))
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"arch {cfg.name}: embed_mode={model.embed_mode} on "
          f"{model.device}")
    rng = np.random.default_rng(0)
    losses = []
    for i in range(args.steps):
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (args.batch, args.seq))).to(model.device)
        losses.append(float(lm_sgd_step_(model, params, tokens, args.lr)))
        if i % args.log_every == 0:
            print(f"step {i:4d} loss={losses[-1]:.4f}")
    print(f"done: final loss {losses[-1]:.4f} "
          f"(ln V = {np.log(cfg.vocab_size):.2f})")
    return losses


if __name__ == "__main__":
    main()
