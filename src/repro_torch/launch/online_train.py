"""Train-while-serving front door — the paper's online-training loop
end to end, in one process and with the freshness contract asserted
(counterpart of ``repro/launch/online_train.py``).

The sequence:

1. train a small CTR model offline and ``deploy()`` it with an external
   VolatileDB + MessageBus, so the returned ``InferenceServer`` is LIVE
   (its consumer subscribes to ``hps.<model>.<table>``);
2. serve a Zipf request stream and record a baseline probe prediction;
3. run N incremental ETC-staged passes on NEW data — the
   ``OnlineTrainer`` seeds its parameter server from the deployed
   weights, trains through the fixed-capacity cache, and each pass
   boundary publishes ONE versioned update batch onto the bus;
4. wait until the last version is visible in LIVE predictions (consumer
   versions reached it AND the probe moved) and then until the probe
   converges onto the freshly-trained oracle — trained embeddings under
   the DEPLOYED dense net, because online updates refresh embeddings
   only. No redeploy, no restart, no server object rebuilt.

``--sanitize`` arms the hot-path sanitizer twin
(``repro_torch.analysis.HotPathMonitor``) over the serving window (probes
+ request stream, WITH the consumer loop applying updates and draining
refreshes mid-window) and fails unless the loop performed exactly one
host sync per served group and no fresh kernel build — the ETC passes
themselves run outside the window, since a train step's loss readback is
a legitimate sync. Everything runs on ``--device`` (``cuda`` unless
``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.online_train --device cpu --passes 3
  PYTHONPATH=src python -m repro_torch.launch.online_train --sanitize
  PYTHONPATH=src python -m repro_torch.launch.online_train --ps cached
"""
from __future__ import annotations

import argparse
import tempfile
import time
from contextlib import nullcontext
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.api import (CreateSolver, DataReaderParams, DenseLayer,
                             Input, Model, SparseEmbedding)
from repro_torch.configs.base import ETCParams
from repro_torch.core.hps.message_bus import MessageBus
from repro_torch.core.hps.volatile_db import VolatileDB
from repro_torch.device import DeviceLike
from repro_torch.online import (OnlineTrainer, UpdatePublisher,
                                probe_prediction, wait_visible)
from repro_torch.train.trainer import put_batch

#: live predictions must land this close to the oracle — updates travel
#: by value, so the residual is serving-stack float noise only (the HPS
#: pooled read rounds multi-hot sums in a different order than the
#: training collection; cf. the 2e-2 tolerance of the served path)
_CONVERGE_TOL = 5e-3


def build_model(batch: int = 128, *, vocab: int = 600, dim: int = 16,
                seed: int = 0, lr: float = 5e-2) -> Model:
    """Small single-collection CTR graph on the synthetic Zipf reader —
    big enough that an ETC cache smaller than the vocab actually evicts."""
    solver = CreateSolver(batch_size=batch, lr=lr, seed=seed)
    reader = DataReaderParams(source="synthetic", num_dense_features=8)
    m = Model(solver, reader, name="online-demo")
    m.add(Input(dense_dim=8))
    m.add(SparseEmbedding(vocab_sizes=[vocab, vocab // 2], dim=dim,
                          top_name="emb", hotness=2))
    m.add(DenseLayer("mlp", ["dense", "emb"], ["logit"], units=(32, 1)))
    m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    return m


def run_online(*, base_steps: int = 30, online_steps: int = 30,
               passes: int = 3, cache_rows: int = 256,
               requests: int = 20, batch: int = 128, ps: str = "staged",
               ps_root: Optional[str] = None,
               deploy_dir: Optional[str] = None, sanitize: bool = False,
               verbose: bool = True, device: DeviceLike = None) -> Dict:
    """The full loop; returns the freshness/overhead metrics dict."""
    say = print if verbose else (lambda *a, **k: None)
    m = build_model(batch)
    m.compile(device=device)
    data_fn = m._reader_data_fn()
    hist = m.fit(data_fn, steps=base_steps)
    say(f"offline: {base_steps} steps, loss={hist[-1]['loss']:.4f}")

    vdb, bus = VolatileDB(), MessageBus()
    deploy_dir = deploy_dir or tempfile.mkdtemp(prefix="online-train-")
    if ps == "cached" and ps_root is None:
        ps_root = tempfile.mkdtemp(prefix="online-ps-")
    server = m.deploy(deploy_dir, cache_capacity=1024, vdb=vdb, bus=bus)
    deployed_dense = m.dense_params()     # the net the LIVE server runs
    probe = data_fn(10_000)
    table_names = [t.name for t in m.cfg.tables]

    metrics: Dict = {}
    server.predict(probe["dense"], probe["cat"])  # warm off-loop
    server.max_batch = batch      # one request == one served group
    server.start()
    for r in range(2):            # warm the serve-loop path
        w = data_fn(30_000 + r)
        out = server.submit(w["dense"], w["cat"]).get(timeout=300)
        if isinstance(out, Exception):
            raise out
    baseline = probe_prediction(server, probe["dense"], probe["cat"],
                                timeout_s=300)

    # ---- incremental ETC passes, publishing at each boundary ----
    # (runs while the server keeps serving, but OUTSIDE any sanitizer
    # window: loss readback is a legitimate host sync)
    publisher = UpdatePublisher(bus, m.name)
    etc_cfg = ETCParams(cache_rows=cache_rows, ps=ps, ps_root=ps_root,
                        passes=passes)
    ot = OnlineTrainer(m, etc_cfg, publisher=publisher)
    t0 = time.perf_counter()
    ohist = ot.fit(lambda s: data_fn(base_steps + s), online_steps)
    etc_s_per_step = (time.perf_counter() - t0) / max(1, online_steps)
    m._params = ot.export_params()
    say(f"online: {online_steps} steps in {passes} passes, "
        f"loss={ohist[-1]['loss']:.4f}, published "
        f"v1..v{publisher.last_version()}")

    # the oracle the live server must converge to: freshly-trained
    # embeddings under the DEPLOYED dense net
    with torch.no_grad():
        logits = m.model.apply(
            {**deployed_dense, "embedding": m._params["embedding"]},
            put_batch({"dense": probe["dense"], "cat": probe["cat"]},
                      m.device))
        oracle = torch.sigmoid(logits).cpu().numpy()

    server.reset_latencies()
    if sanitize:
        from repro_torch.analysis import HotPathMonitor
        mon = HotPathMonitor("online-train")
    else:
        mon = None
    with mon if mon is not None else nullcontext():
        res = wait_visible(server, publisher, publisher.last_version(),
                           probe["dense"], probe["cat"], baseline=baseline,
                           tables=table_names, timeout_s=300)
        # versions applied -> L2/L3 hold the rows; keep probing while the
        # bounded refresh drains the remaining L1 backlog
        final = res["prediction"]
        deadline = time.monotonic() + 300
        while np.abs(final - oracle).max() > _CONVERGE_TOL:
            if time.monotonic() >= deadline:
                raise SystemExit(
                    f"live predictions stuck "
                    f"{np.abs(final - oracle).max():.2e} from the "
                    f"oracle (tol {_CONVERGE_TOL})")
            final = probe_prediction(server, probe["dense"], probe["cat"],
                                     timeout_s=300)
        for r in range(requests):      # keep serving, fresh rows in
            w = data_fn(20_000 + r)
            out = server.submit(w["dense"], w["cat"]).get(timeout=300)
            if isinstance(out, Exception):
                raise out
    counters = server.counters()
    server.stop()

    d_base = float(np.abs(baseline - oracle).max())
    d_final = float(np.abs(final - oracle).max())
    if d_base <= d_final:
        raise SystemExit(
            f"freshness loop did not move the live predictions toward "
            f"the oracle: baseline dist {d_base:.2e} <= final "
            f"{d_final:.2e}")
    if mon is not None:
        groups = counters["groups_served"]
        summ = mon.summary()
        if summ["syncs"] != groups or summ["compiles"] != 0:
            raise SystemExit(
                f"hot-path sanitizer: expected {groups} host syncs "
                f"(one per served group, consumer loop active) and 0 "
                f"kernel builds; observed {summ['syncs']} syncs "
                f"({summ['d2h']} d2h, {summ['block']} block) and "
                f"{summ['compiles']} build(s)")
        say(f"sanitizer: {summ['syncs']} syncs over {groups} served "
            "groups with the consumer loop active, 0 kernel builds")

    metrics.update({
        "freshness_lag_s": res["lag_s"], "freshness_polls": res["polls"],
        "versions_published": publisher.last_version(),
        "updates_applied": counters["updates_applied"],
        "rows_refreshed": counters["rows_refreshed"],
        "etc_s_per_step": etc_s_per_step,
        "baseline_dist": d_base, "final_dist": d_final,
        "etc_evictions": ot.etc.evictions, "etc_pulls": ot.etc.pulls,
    })
    say(f"freshness: v{metrics['versions_published']} visible in live "
        f"predictions {res['lag_s'] * 1e3:.1f}ms after publish "
        f"({res['polls']} probes); baseline->oracle dist "
        f"{d_base:.2e} -> {d_final:.2e}; "
        f"{metrics['updates_applied']} update msgs applied, "
        f"{metrics['rows_refreshed']} L1 rows refreshed; ETC "
        f"{etc_s_per_step * 1e3:.1f}ms/step "
        f"({ot.etc.pulls} pulls, {ot.etc.evictions} evictions)")
    return metrics


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base-steps", type=int, default=30)
    ap.add_argument("--online-steps", type=int, default=30)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--cache-rows", type=int, default=256)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--ps", choices=("staged", "cached"),
                    default="staged")
    ap.add_argument("--sanitize", action="store_true",
                    help="fail unless the serving window holds the "
                    "hot-path invariants with the consumer loop active")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    a = ap.parse_args(argv)
    run_online(base_steps=a.base_steps, online_steps=a.online_steps,
               passes=a.passes, cache_rows=a.cache_rows,
               requests=a.requests, batch=a.batch, ps=a.ps,
               sanitize=a.sanitize, device=a.device)


if __name__ == "__main__":
    main()
