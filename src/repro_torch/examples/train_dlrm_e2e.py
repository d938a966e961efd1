"""End-to-end driver (the twin of ``examples/train_dlrm_e2e.py``): train
a DLRM of ~100M parameters through the graph API with the full
production substrate: fault-tolerant Trainer, async atomic checkpoints,
Zipf synthetic Criteo-like data, AUC eval, and an injected mid-run
failure to demonstrate checkpoint-restore + deterministic replay.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_dlrm_e2e \
          [--device cpu] [--steps 300] [--batch 1024] [--vocab-cap 60000]

``--vocab-cap`` caps each of the 26 Criteo vocabularies (60,000 gives
the reference's ~100M parameters at D 64); ``--ckpt-dir`` defaults to a
temporary directory.
"""
import argparse
import shutil
import tempfile
import time

import numpy as np

from repro_torch.api import (
    CreateSolver, DataReaderParams, DenseLayer, Input, Model,
    SparseEmbedding,
)
from repro_torch.configs.registry import CRITEO_VOCAB_SIZES
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.models.recsys.layers import auc


def build_model(batch: int, lr: float, vocab_cap: int = 60_000,
                ckpt_interval: int = 50) -> Model:
    """26 tables of capped vocabularies at D 64."""
    sizes = [min(v, vocab_cap) for v in CRITEO_VOCAB_SIZES]
    m = Model(CreateSolver(batch_size=batch, lr=lr,
                           ckpt_interval=ckpt_interval),
              DataReaderParams(num_dense_features=13),
              name="dlrm-e2e")
    m.add(Input(dense_dim=13))
    m.add(SparseEmbedding(
        vocab_sizes=sizes, dim=64, top_name="emb",
        table_names=[f"C{i + 1}" for i in range(len(sizes))]))
    m.add(DenseLayer("mlp", ["dense"], ["bot"], units=(256, 128, 64),
                     final_activation=True))
    m.add(DenseLayer("dot_interaction", ["bot", "emb"], ["inter"]))
    m.add(DenseLayer("concat", ["bot", "inter"], ["top_in"]))
    m.add(DenseLayer("mlp", ["top_in"], ["logit"],
                     units=(512, 256, 1)))
    m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    cfg = m.to_recsys_config()
    print(f"model: {cfg.num_tables} tables, "
          f"{cfg.total_embedding_params / 1e6:.1f}M embedding params")
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--vocab-cap", type=int, default=60_000)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    tmp = None
    if args.ckpt_dir is None:
        tmp = args.ckpt_dir = tempfile.mkdtemp(prefix="e2e_ckpt_")
    else:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    try:
        m = build_model(args.batch, 5e-3, args.vocab_cap,
                        args.ckpt_interval)
        m.compile(device=args.device)

        armed = {"on": True}
        failures = []

        def inject(step):
            if step == args.steps // 2 and armed["on"]:
                armed["on"] = False
                failures.append(step)
                print(f"*** injecting node failure at step {step} ***")
                raise RuntimeError("injected failure")

        t0 = time.time()
        hist = m.fit(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     log_every=25, failure_injector=inject)
        dt = time.time() - t0
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    print(f"\n{len(hist)} steps in {dt:.1f}s "
          f"({args.batch * len(hist) / dt:.0f} samples/s)")
    print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    print(f"stragglers flagged: {m.stragglers}")

    # -- eval AUC on held-out steps ----------------------------------------
    data = SyntheticCTR(m.cfg, args.batch)
    probs_all, labels_all = [], []
    for s in range(10_000, 10_005):
        b = data.batch(s)
        probs_all.append(m.predict(b))
        labels_all.append(b["label"])
    # AUC is rank-based, so probabilities work as well as logits
    a = auc(np.concatenate(probs_all), np.concatenate(labels_all))
    print(f"held-out AUC: {a:.4f} (planted-signal synthetic data)")
    assert a > 0.6, "training failed to learn the planted signal"
    return {"history": hist, "failures": failures, "auc": a}


if __name__ == "__main__":
    main()
