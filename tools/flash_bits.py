#!/usr/bin/env python3
"""The bits of K8's gradients at the shapes its bf16 D 64 long forms take,
for the port found under ``--src``, so that two checkouts can be held to
the same bits on one card:

  python3 tools/flash_bits.py [--src PATH] [--out FILE] [--against FILE]

Each case draws seeded bf16 ``q, k, v, do``, takes ``o`` and ``lse`` from
the checkout's K7 and runs its K8 once; the line it prints holds, a case,
the SHA-256 of the bytes of ``o``, ``lse``, ``dq``, ``dk`` and ``dv``.
``--out`` writes that JSON to a file; ``--against`` reads another
checkout's file and exits 1 unless every case it shares has the same
digests (the same bits, as ``torch.equal`` without its -0.0 == 0.0).
Cases (``(BH, BKV, Sq, Sk, causal, window, q_pos0)``): seamless-m4t-
large-v2's decoder self-attention and granite-moe-3b-a800m's training
shape (more than 512 keys: the long forms), granite's first, a middle
and the last of 16 sequence-parallel shards, a window, and the cross
cases of ``tests/test_torch_kernels.py`` just past the short form
(``x64over``) and with more keys than queries (``x64morekeys``).
Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (BH, BKV, Sq, Sk, causal, window, q_pos0), all at D 64
CASES = {
    "decoder": (16, 16, 4096, 4096, True, None, 0),
    "granite": (24, 8, 4096, 4096, True, None, 0),
    "granite shard 0": (24, 8, 256, 4096, True, None, 0),
    "granite shard 7": (24, 8, 256, 4096, True, None, 1792),
    "granite shard 15": (24, 8, 256, 4096, True, None, 3840),
    "window": (6, 2, 700, 700, True, 300, 0),
    "x64over": (8, 2, 700, 513, False, None, 0),
    "x64morekeys": (4, 4, 65, 1000, False, None, 0),
}


def digests(dev) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as k78
    out = {}
    for i, (name, (bh, bkv, sq, sk, causal, window, p)) in enumerate(
            CASES.items()):
        g = torch.Generator().manual_seed(100 + i)
        q, k, v, do = (torch.randn((n, t, 64), generator=g)
                       .to(torch.bfloat16).to(dev)
                       for n, t in ((bh, sq), (bkv, sk), (bkv, sk), (bh, sq)))
        shard = {"q_pos0": p} if p else {}
        o, lse = k78.flash_fwd(q, k, v, causal=causal, window=window,
                               **shard)
        dq, dk, dv = k78.flash_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window, **shard)
        torch.cuda.synchronize()
        out[name] = {
            what: hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                                 .numpy().tobytes()).hexdigest()
            for what, t in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk),
                            ("dv", dv))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--out")
    ap.add_argument("--against")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    got = digests(torch.device("cuda", 0))
    print(json.dumps({"src": args.src, "digests": got}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(got, f)
    if not args.against:
        return 0
    with open(args.against) as f:
        other = json.load(f)
    differ = {name: [w for w in d if d[w] != other[name][w]]
              for name, d in got.items() if name in other}
    differ = {name: ws for name, ws in differ.items() if ws}
    print(json.dumps({"against": args.against,
                      "same": sorted(set(got) & set(other) - set(differ)),
                      "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
