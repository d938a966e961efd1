#!/usr/bin/env python3
"""Host-to-device staging of one HPS batch, at ``chip_smoke.py``'s full-width
DLRM serving shapes, through the port found under ``--src``:

  python3 tools/h2d_times.py [--src PATH] [--rows N] [--tables T]

A batch is ``--tables`` slot blocks of ``[rows, 1]`` int32 (the L1-warm
case) or, with ``--scatter K``, each also a deferred scatter of ``K`` rows
(int64 flat rows, ``[K, 128]`` f32 rows). It goes to the card three ways,
each timed to its last byte (a ``torch.cuda.synchronize`` a batch), median
of ``--reps`` batches, with the card idle and again behind a queued
``--busy-ms`` of device work (the dense net a pipelined engine overlaps):

- ``plain``: one ``device.to_device`` (pageable) copy an array;
- ``plain, a wait a table``: the same with a synchronize after each
  table, as ``HPS.lookup_stage_sync`` runs;
- ``one copy``: ``device.to_device_many`` over the whole batch (when the
  checkout has it).

Prints the card's name and power limit, then one JSON line of host ms.
Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(devmod, dev, rows: int, tables: int, scatter: int, reps: int,
            busy_ms: float) -> dict:
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    batch = []
    for _ in range(tables):
        arrays = [rng.integers(0, 1 << 17, (rows, 1)).astype(np.int32)]
        if scatter:
            arrays += [rng.integers(0, 1 << 17, scatter).astype(np.int64),
                       rng.standard_normal((scatter, 128), np.float32)]
        batch.append(arrays)
    flat = [a for arrays in batch for a in arrays]
    big = torch.randn(4096, 4096, device=dev)
    per_mm = None

    def busy():
        nonlocal per_mm
        if busy_ms <= 0:
            return
        if per_mm is None:          # ms of one matmul, measured once
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(10):
                big @ big
            torch.cuda.synchronize(dev)
            per_mm = 1e3 * (time.perf_counter() - t0) / 10
        for _ in range(max(1, round(busy_ms / per_mm))):
            big @ big

    def plain():
        for a in flat:
            devmod.to_device(a, dev)

    def plain_waits():
        for arrays in batch:
            for a in arrays:
                devmod.to_device(a, dev)
            torch.cuda.synchronize(dev)

    ways = {"plain": plain, "plain, a wait a table": plain_waits}
    if hasattr(devmod, "to_device_many"):
        ways["one copy"] = lambda: devmod.to_device_many(flat, dev)
    out = {}
    for loaded in (False, True):
        for name, fn in ways.items():
            ms = []
            for i in range(reps + 3):
                torch.cuda.synchronize(dev)
                if loaded:
                    busy()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize(dev)
                if i >= 3:
                    ms.append(1e3 * (t1 - t0))
            key = name + (f", behind {busy_ms:g} ms of device work"
                          if loaded else "")
            out[key] = float(np.median(ms))
        if busy_ms <= 0:
            break
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--tables", type=int, default=26)
    ap.add_argument("--scatter", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--busy-ms", type=float, default=5.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("h2d_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import device as devmod
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out = measure(devmod, torch.device("cuda", 0), args.rows, args.tables,
                  args.scatter, args.reps, args.busy_ms)
    print(json.dumps({"label": args.label, "src": args.src,
                      "rows": args.rows, "tables": args.tables,
                      "scatter": args.scatter, "host_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
