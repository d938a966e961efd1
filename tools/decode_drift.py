#!/usr/bin/env python3
"""How far an LM's bf16 decode replay drifts from its prefill, seed by
seed, for the port found under ``--src``:

  python3 tools/decode_drift.py [--src PATH] [--arch NAME] [SEED ...]

For each seed (default 0-3), as ``chip_smoke.py``'s LM phase builds it:
full-width, full-depth ``--arch`` with random weights from the seed (an
MoE model on its copy whose capacity factor drops nothing), the first
``RUN.prompt`` tokens of the seed's Zipf batch replayed through
``decode_step`` on the kernels, against the prefill of the same tokens
on the kernels and on the plain path: max abs difference, correlation,
and whether ``chip_smoke.DECODE_TOL`` holds; then the same replay in f32
on the plain path (``chip_smoke.f32_decode_check``). Prints the card's
name and power limit, then a line a seed. Needs a CUDA device; exits 2
without one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("seeds", nargs="*", type=int, default=[0, 1, 2, 3])
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.configs.registry import get_lm_config
    from repro_torch.models.lm.backbone import LMModel
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_lm_config(args.arch)
    if cfg.moe is not None:
        cfg = cs.no_drop(cfg)
    dev = torch.device("cuda", 0)
    b, s, p = cs.RUN.lm_batch, cs.RUN.lm_seq, cs.RUN.prompt
    tol = cs.DECODE_TOL
    for seed in args.seeds:
        model = LMModel(cfg, device=dev)
        plain = LMModel(cfg, device=dev, use_kernels=False)
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        rng = np.random.default_rng((seed, 7))
        prompt = torch.from_numpy(cs.zipf_ids(rng, cfg.vocab_size, (b, s),
                                              a=1.2)[:, :p].copy()).to(dev)
        v = cfg.vocab_size
        parts = []
        with torch.inference_mode():
            cache = model.init_cache(b, s)
            for i in range(p):
                step, cache = model.decode_step(
                    params, prompt[:, i:i + 1], cache,
                    torch.full((b,), i, device=dev))
            got = step[:, :v].float().cpu().numpy()
            for name, m in (("kernels", model), ("plain", plain)):
                ref = m.prefill(params, {"tokens": prompt})[:, :v]
                ref = ref.float().cpu().numpy()
                held = np.allclose(got, ref, rtol=tol.rtol, atol=tol.atol)
                parts.append(
                    f"prefill on the {name} {np.abs(got - ref).max():.4g} / "
                    f"{np.corrcoef(got.ravel(), ref.ravel())[0, 1]:.6f} "
                    f"({'held' if held else 'not held'})")
            del cache, step
            parts.append(cs.f32_decode_check(dev, cfg, params, prompt))
        print(f"{cfg.name} seed {seed}, {p}-token decode replay (bf16) vs "
              "its prefill, max abs / correlation (DECODE_TOL rtol "
              f"{tol.rtol}, atol {tol.atol}): " + "; ".join(parts),
              flush=True)
        del model, plain, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
