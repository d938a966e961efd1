"""Training launcher, counterpart of the LM branch of
``repro/launch/train.py``, and the LM train steps it runs.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \\
      --steps 5 --batch 1 --seq 4096          # on the card, full width

As the reference: the model of ``--arch`` (reduced by ``--smoke``) from
seed-0 weights, a batch of tokens drawn uniformly from the vocabulary
each step (numpy, seed 0), and plain SGD, ``p - lr * g``. Unlike the
reference, one device does not imply the smoke reduction: the card trains
an arch at full width. The step runs on ``cuda`` unless ``--device cpu``.
The recsys recipes and the mesh, ``--mode``, ``--comm`` and
``--ckpt-dir`` flags raise ``NotImplementedError`` naming their ROADMAP
items.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.models.lm.backbone import LMModel
from repro_torch.optim.optimizers import Optimizer
from repro_torch.roadmap import FRONT_DOORS, MULTI_DEVICE, not_ported
from repro_torch.tree import flatten, tree_map

#: the reference's recsys recipes (its ``RECSYS_RECIPES``)
RECSYS_ARCHS = ("crossdeep-criteo", "dcn-criteo", "deepfm-criteo",
                "dlrm-criteo", "neumf-criteo", "twotower-criteo",
                "wdl-criteo")


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
    if args.arch in RECSYS_ARCHS:
        raise not_ported(f"--arch {args.arch} (the recsys branch of the "
                         "launcher)", FRONT_DOORS)
    if args.mesh != "auto":
        raise not_ported(f"--mesh {args.mesh}", MULTI_DEVICE)
    if args.mode != "gspmd":
        raise not_ported(f"--mode {args.mode}", MULTI_DEVICE)
    if args.comm != "auto":
        raise not_ported(f"--comm {args.comm}", MULTI_DEVICE)
    if args.ckpt_dir is not None:
        raise not_ported("--ckpt-dir (checkpointed LM training)",
                         FRONT_DOORS)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Train; returns the loss of every step."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=sorted(LM_ARCHS) + list(RECSYS_ARCHS))
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
    ap.add_argument("--mode", default="gspmd", choices=["gspmd", "manual"])
    ap.add_argument("--comm", default="auto",
                    choices=["auto", "allgather_rs", "all_to_all"])
    ap.add_argument("--mesh", default="auto")
    args = ap.parse_args(argv)
    _refuse(args)

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
