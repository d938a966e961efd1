"""Model-parallel training smoke: fit on a (2,2) mesh, serve the result
(the twin of ``examples/mp_train_smoke.py``).

One process a device, under ``torchrun`` (gloo ranks with ``--device
cpu``, NCCL ranks on cards otherwise); the full MP path end to end:

  1. train a tiny DLRM with ``Solver(mesh_shape=(2, 2))``: embeddings
     shard over the mesh per the placement planner, the dense net runs
     data-parallel, and the loss trajectory must match a single-device
     run of the same graph (a (1, 1) mesh on rank 0);
  2. deploy the mesh-trained model to a ps.json bundle (rank 0 writes);
  3. rebuild the server FROM THE BUNDLE ALONE and serve one prediction
     batch, cross-checked against the training graph's forward pass.

Run:  PYTHONPATH=src torchrun --nproc-per-node 4 \\
          -m repro_torch.examples.mp_train_smoke --device cpu
      (``--mesh 1x1`` with one process, as on a one-card machine)
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch.distributed as dist

from repro_torch.api import (
    CreateSolver, DataReaderParams, DenseLayer, Input, Model,
    SparseEmbedding,
)
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.serve import build_server_from_config
from repro_torch.launch.train import (
    join_process_group, leave_process_group, mesh_shape_arg)

#: the MP loss trajectory against the single-device run's (the f32 sum
#: order; a bf16 layer's weight gradients round after the sum in both)
LOSS_TOL = 1e-5


def build(mesh, device, batch: int = 64) -> Model:
    solver = CreateSolver(batch_size=batch, lr=1e-2)
    reader = DataReaderParams(source="synthetic", num_dense_features=13)
    m = Model(solver, reader, name="mp-smoke-dlrm", mesh=mesh)
    m.add(Input(dense_dim=13))
    m.add(SparseEmbedding(vocab_sizes=[1000, 584, 1000, 306, 24, 634],
                          dim=16, top_name="emb"))
    m.add(DenseLayer("mlp", ["dense"], ["bot"], units=(32, 16),
                     final_activation=True))
    m.add(DenseLayer("dot_interaction", ["bot", "emb"], ["inter"]))
    m.add(DenseLayer("concat", ["bot", "inter"], ["top_in"]))
    m.add(DenseLayer("mlp", ["top_in"], ["logit"], units=(32, 16, 1)))
    m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    m.compile(device=device)
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default="2x2", help="RxC over the ranks")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    joined = join_process_group(args.device)
    shape = mesh_shape_arg(args.mesh) or (meshlib.world_size(), 1)

    # -- 1. MP fit, checked against the single-device trajectory ------------
    mesh = meshlib.make_test_mesh(shape)
    one = meshlib.make_test_mesh((1, 1))     # rank 0 alone
    lead = meshlib.axis_index(mesh, meshlib.all_axes(mesh)) == 0
    mp = build(mesh, args.device)
    if lead:
        print(f"mesh: {meshlib.mesh_shape(mesh)} over "
              f"{meshlib.world_size()} ranks")
    hist_mp = mp.fit(steps=args.steps, log_every=5)
    out = {}
    if meshlib.in_mesh(one):
        hist_1d = build(one, args.device).fit(steps=args.steps)
        dev = max(abs(a["loss"] - b["loss"])
                  for a, b in zip(hist_mp, hist_1d))
        if dev > LOSS_TOL:
            raise SystemExit(f"MP loss trajectory deviates {dev} from the "
                             f"single-device run (bound {LOSS_TOL})")
        print(f"loss {hist_mp[0]['loss']:.4f} -> "
              f"{hist_mp[-1]['loss']:.4f} (matches 1-device run, max dev "
              f"{dev:.2e})")
        out["loss_dev"] = dev
    out["losses"] = [h["loss"] for h in hist_mp]

    # -- 2./3. deploy the mesh-trained model, serve from the bundle ---------
    root = tempfile.mkdtemp() if lead else None
    if dist.is_initialized():               # every rank deploys into one
        box = [root]                        # directory (rank 0 writes)
        dist.broadcast_object_list(box, src=0)
        root = box[0]
    mp.deploy(root, cache_capacity=512)
    req = SyntheticCTR(mp.cfg, 64).batch(999)
    want = mp.predict(req)
    if lead:
        server, _ = build_server_from_config(os.path.join(root, "ps.json"),
                                             device=mp.device)
        preds = server.predict(req["dense"], req["cat"])
        if preds.shape != (64,):
            raise SystemExit(f"expected 64 predictions, got {preds.shape}")
        err = float(np.abs(preds - want).max())
        if err > 1e-6:
            raise SystemExit(f"bundle-served predictions deviate {err} "
                             "from the training-graph forward pass")
        print(f"served {preds.shape[0]} predictions from the rebuilt "
              f"bundle (max dev vs training graph {err:.2e})")
        print("mp-train-smoke OK")
        out["serve_err"] = err
        shutil.rmtree(root, ignore_errors=True)
    if joined:
        leave_process_group()
    return out


if __name__ == "__main__":
    main()
