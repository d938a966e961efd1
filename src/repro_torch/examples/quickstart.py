"""Quickstart: the paper's workflow through the graph API (the twin of
``examples/quickstart.py``).

  1. declare a DLRM as a HugeCTR-style layer graph (Solver + Input +
     SparseEmbedding + DenseLayers wired by tensor names),
  2. compile (the graph lowers onto the embedding planner + trainer)
     and train a few steps on synthetic Zipf CTR data,
  3. deploy: write the ps.json serving bundle, then reconstruct the
     HPS-backed server FROM THE BUNDLE ALONE and serve predictions.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart \
          [--device cpu] [--steps 20]
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.api import (
    CreateSolver, DataReaderParams, DenseLayer, Input, Model,
    SparseEmbedding,
)
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.launch.serve import build_server_from_config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    # -- 1. declare the model graph -----------------------------------------
    solver = CreateSolver(batch_size=256, lr=1e-2)
    reader = DataReaderParams(source="synthetic", num_dense_features=13)
    m = Model(solver, reader, name="quickstart-dlrm")
    m.add(Input(dense_dim=13))
    m.add(SparseEmbedding(vocab_sizes=[1000, 584, 1000, 306, 24, 634],
                          dim=16, top_name="emb"))
    m.add(DenseLayer("mlp", ["dense"], ["bot"], units=(32, 16),
                     final_activation=True))
    m.add(DenseLayer("dot_interaction", ["bot", "emb"], ["inter"]))
    m.add(DenseLayer("concat", ["bot", "inter"], ["top_in"]))
    m.add(DenseLayer("mlp", ["top_in"], ["logit"], units=(32, 16, 1)))
    m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))

    # -- 2. compile (lowering) + train ---------------------------------------
    m.compile(device=args.device)
    m.summary()
    for name, group in m.model.embedding.groups.items():
        print(f"embedding group {name!r}: {group.num_tables} tables, "
              f"{group.total_rows} rows ({group.strategy})")
    hist = m.fit(steps=args.steps, log_every=5)
    print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")

    # -- 3. deploy: bundle -> config-driven server ---------------------------
    with tempfile.TemporaryDirectory() as root:
        m.deploy(root, cache_capacity=512)   # pdb/ graph.json dense.npz ps.json
        server, loaded = build_server_from_config(
            os.path.join(root, "ps.json"), device=args.device)
        try:
            data = SyntheticCTR(loaded.to_recsys_config(), 256)
            warm = data.batch(998)
            server.predict(warm["dense"], warm["cat"])  # cache warmup
            server.reset_latencies()
            req = data.batch(999)
            preds = server.predict(req["dense"], req["cat"])
            want = m.predict(req)
            np.testing.assert_allclose(preds, want, rtol=2e-2, atol=2e-2)
            hit = float(np.mean(list(
                server.hps.stats()["l1_hit_rate"].values())))
            p50 = server.latency_percentiles()["p50"]
        finally:
            server.close()
    print(f"served {len(preds)} predictions from the ps.json bundle; "
          f"p50 latency = {p50:.2f} ms; L1 hit rate = {hit:.2f}")
    print("config-driven server matches the training forward pass")
    return {"losses": [h["loss"] for h in hist], "predictions": len(preds),
            "l1_hit_rate": hit}


if __name__ == "__main__":
    main()
