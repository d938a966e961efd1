"""Assigned-architecture driver (the twin of
``examples/lm_pretrain_smoke.py``): pick an LM arch (reduced to CPU
scale) and run a short pre-training loop with the hybrid (hot/cold)
vocabulary embedding, the paper's technique applied to LM token tables.

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_pretrain_smoke \
          [--device cpu] [--arch olmo-1b] [--steps 30]

The dense decoders, recurrentgemma, the MoE decoders (granite) and
xLSTM train; the encoder-decoders, which the port has not reached yet,
raise ``NotImplementedError`` naming their ROADMAP item.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.launch.train import lm_sgd_step_
from repro_torch.models.lm.backbone import LMModel


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b", choices=sorted(LM_ARCHS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduce_for_smoke(LM_ARCHS[args.arch])
    print(f"arch={args.arch} (smoke-reduced): {cfg.num_layers}L "
          f"d={cfg.d_model} vocab={cfg.vocab_size} "
          f"pattern={cfg.block_pattern}")

    model = LMModel(cfg, device=args.device, embed_mode="hybrid",
                    hot_fraction=0.1, loss_chunk=32)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"embed mode={model.embed_mode}: hot={model.hot_rows} rows, "
          f"cold={model.cold_rows} rows, on {model.device}")

    lr = 3e-3
    rng = np.random.default_rng(0)

    def batch():
        # zipf tokens so the hot table actually serves most lookups
        u = rng.random((args.batch, args.seq))
        a = 1.2
        x = (u * ((cfg.vocab_size + 1.) ** (1 - a) - 1.) + 1.) \
            ** (1 / (1 - a))
        ids = np.clip(x.astype(np.int64) - 1, 0, cfg.vocab_size - 1)
        return torch.from_numpy(ids).to(model.device)

    losses = []
    for i in range(args.steps):
        losses.append(float(lm_sgd_step_(model, params, batch(), lr)))
        if i % 10 == 0:
            print(f"step {i:3d}  loss={losses[-1]:.4f}")
    print(f"\nloss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(ln V = {np.log(cfg.vocab_size):.2f})")
    assert losses[-1] < losses[0], "no learning signal"
    print("OK")
    return losses


if __name__ == "__main__":
    main()
