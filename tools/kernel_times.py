#!/usr/bin/env python3
"""Device times of the port's hand-written kernels at the shapes
``chip_smoke.py``'s main paths give them, for the port found under
``--src``, so that two checkouts can be timed in turns on one card:

  python3 tools/kernel_times.py [--src PATH] [--label NAME] [CASE ...]

``--src`` defaults to this checkout's ``src/``; with no CASE every case of
:data:`CASES` runs. Each case takes its inputs from ``chip_smoke.py``'s own
functions and its run settings (``chip_smoke.RUN``), so that its shapes and
ids follow the smoke's. Each time is the mean of calls replayed from a CUDA
graph (``chip_smoke.graph_ms``). Prints the card's name and power limit,
then one JSON line. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lm_k3(cs, dev, table: int):
    from repro_torch.configs.registry import get_lm_config
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.models.lm.backbone import LMModel
    cfg = get_lm_config(cs.RUN.lm_arch)
    tokens = cs.lm_tokens(cs.RUN, cfg, dev, cs.RUN.lm_train_batch,
                          cs.RUN.lm_seq)
    shape, rows, dp = cs.lm_k3_inputs(LMModel(cfg, device=dev),
                                      tokens)[table]
    return lambda: k1.lookup_bwd(shape, rows, dp), 5


def _dlrm_k3(cs, dev):
    import torch
    from repro_torch.kernels import embedding_lookup as k1
    groups = cs.training_rows(cs.RUN, dev)
    v, rows = groups[max(groups, key=lambda k: groups[k][0])]
    dp = torch.randn((rows.shape[0], 128),
                     generator=torch.Generator().manual_seed(1)).to(dev)
    return lambda: k1.lookup_bwd((v, 128), rows, dp), 4


def _k7(cs, dev):
    import torch
    from repro_torch.kernels import flash_attention as k78
    b, (hq, hkv, d) = cs.RUN.lm_batch, cs.lm_attn_shape(cs.RUN)
    q, k, v = cs.randn_heads(torch.Generator().manual_seed(7), dev,
                             (b * hq, b * hkv, b * hkv), cs.RUN.attn_seq, d,
                             torch.bfloat16)
    return lambda: k78.flash_fwd(q, k, v, causal=True), 5


def _k8(cs, dev):
    import torch
    from repro_torch.kernels import flash_attention as k78
    hq, hkv, d = cs.lm_attn_shape(cs.RUN)
    ins = cs.flash_bwd_inputs(torch.Generator().manual_seed(8), dev, hq, hkv,
                              cs.RUN.attn_seq, d, torch.bfloat16)
    return lambda: k78.flash_bwd(*ins, causal=True), 5


#: case -> builder ``(chip_smoke, device) -> (call, CUDA graph reps)``: K3
#: at the LM token tables (``lm_k3_check``'s inputs) and at the largest
#: DLRM embedding group (``kernel_phase``'s), K7 at the LM prefill shape (a)
#: and K8 at the LM training shape (a)
CASES = {
    "lookup_bwd lm_hot": lambda cs, dev: _lm_k3(cs, dev, 0),
    "lookup_bwd lm_cold": lambda cs, dev: _lm_k3(cs, dev, 1),
    "lookup_bwd dlrm": _dlrm_k3,
    "flash_fwd (a)": _k7,
    "flash_bwd (a)": _k8,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("cases", nargs="*", metavar="CASE",
                    help=f"cases to time, of {list(CASES)} (default: all)")
    args = ap.parse_args()
    unknown = set(args.cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; known: {list(CASES)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    ms = {}
    for name in args.cases or CASES:
        fn, reps = CASES[name](cs, dev)
        ms[name] = cs.graph_ms(fn, reps)
        del fn
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "src": args.src,
                      "device_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
