"""Embedding Training Cache demo, paper section 1 "Online training" (the
twin of ``examples/etc_terabyte_training.py``):

train a model whose embedding tables DO NOT FIT in (simulated) device
memory: the ETC stages small working sets against a disk-backed
parameter server, HugeCTR's Staged-PS/Cached-PS hierarchy. The pooled
read of the cache is one K1 launch forward and one K3 backward on the
card.

Run:  PYTHONPATH=src python -m repro_torch.examples.etc_terabyte_training \
          [--device cpu] [--vocab 1000000] [--steps 60]
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.base import EmbeddingTableConfig, TrainConfig
from repro_torch.core.etc.cache import EmbeddingTrainingCache, cached_lookup
from repro_torch.core.etc.parameter_server import CachedPS
from repro_torch.optim.sparse import rowwise_adagrad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--vocab", type=int, default=1_000_000,
                    help="rows a table (2 tables at D 64)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)

    # 2 tables x 1M rows x 64 dims = 512 MB of f32 "model" vs 1k-row caches
    vocab, dim, cap, batch = args.vocab, 64, 1024, 512
    tabs = [EmbeddingTableConfig(f"t{i}", vocab, dim, hotness=2)
            for i in range(2)]

    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        ps = CachedPS(tabs, root)      # disk-backed ground truth
        print(f"initialized {2 * vocab * dim * 4 / 2**20:.0f} MiB of "
              f"disk-backed tables in {time.time() - t0:.1f}s")
        etc = EmbeddingTrainingCache(tabs, capacity=cap, ps=ps,
                                     device=args.device)
        params = etc.init_params()
        print(f"device-resident cache: "
              f"{params['cache'].nbytes / 2**20:.1f} MiB "
              f"({cap} rows/table vs {vocab} total) on {etc.device}")

        opt = rowwise_adagrad(TrainConfig(learning_rate=0.05))
        rng = np.random.default_rng(0)
        target_w = torch.from_numpy(
            rng.normal(size=(dim,)).astype(np.float32)).to(etc.device)

        def train_step(params, remapped, labels):
            cache = params["cache"].detach().requires_grad_()
            pooled = cached_lookup({"cache": cache}, remapped)  # [B, T, D]
            logit = pooled.sum(1) @ target_w
            loss = torch.mean(torch.clamp_min(logit, 0) - logit * labels
                              + torch.log1p(torch.exp(-logit.abs())))
            g, = torch.autograd.grad(loss, cache)
            t, c, d_ = cache.shape
            with torch.no_grad():
                new_p, new_s = opt.update(
                    {"x": g.reshape(t * c, d_)},
                    {"acc": {"x": params["acc"].reshape(t * c)}},
                    {"x": params["cache"].reshape(t * c, d_)})
            return {"cache": new_p["x"].reshape(t, c, d_),
                    "acc": new_s["acc"]["x"].reshape(t, c)}, loss.detach()

        def zipf(size):
            # a=1.6: the hot head recurs often enough to learn in the demo
            u = rng.random(size)
            x = (u * ((vocab + 1.0) ** -0.6 - 1.0) + 1.0) ** (1 / -0.6)
            return np.clip(np.floor(x).astype(np.int64) - 1, 0,
                           vocab - 1).astype(np.int32)

        losses = []
        for i in range(args.steps):
            cat = zipf((batch, 2, 2))
            params, remapped = etc.prepare(params, cat)  # host staging
            # planted signal: per-id parity, learnable purely through the
            # embedding rows, which is the point of the demo
            labels = (cat[:, 0, 0] % 2 == 0).astype(np.float32)
            params, loss = train_step(
                params, torch.from_numpy(remapped).to(etc.device),
                torch.from_numpy(labels).to(etc.device))
            losses.append(float(loss))
            if i % 10 == 0:
                print(f"step {i:3d} loss={losses[-1]:.4f} "
                      f"pulls={etc.pulls} evictions={etc.evictions}")

        etc.flush(params)
        ps.flush()
        first = float(np.mean(losses[:10]))
        last = float(np.mean(losses[-10:]))
        print(f"\nfinal: loss {first:.4f} -> {last:.4f} (10-step means); "
              f"{etc.pulls} rows pulled, {etc.evictions} evicted; "
              f"trained state persisted to disk")
        assert last < first, "hot-id signal must be learnable"
    return {"losses": losses, "pulls": etc.pulls,
            "evictions": etc.evictions}


if __name__ == "__main__":
    main()
