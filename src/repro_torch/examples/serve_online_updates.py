"""Online-training serving demo, paper Figure 2's blue and red paths (the
twin of ``examples/serve_online_updates.py``).

A trainer keeps learning while an inference node serves TWO models from
one parameter-server process (the ensemble deployment unit: shared
PDB/VDB/bus, per-model L1 caches):

  trainer --(Producer / Kafka-style bus)--> VDB + PDB --(refresh)--> L1

The "online" model receives the update stream and its predictions drift;
the "static" model shares every storage level with it and must not move
at all: one model's updates never touch another's tables. Per-model
serving stats print at the end.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_online_updates \
          [--device cpu] [--windows 3]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import RECSYS_ARCHS, reduce_recsys_for_smoke
from repro_torch.core.hps.hps import HPS
from repro_torch.core.hps.message_bus import MessageBus, Producer
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.core.hps.volatile_db import VolatileDB
from repro_torch.data.pipeline import put_batch
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.models.recsys.model import RecsysModel
from repro_torch.serve.server import (
    InferenceServer, MultiModelServer, deploy_from_training,
)
from repro_torch.train.train_step import build_train_step, init_opt_state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--windows", type=int, default=3,
                    help="online training windows of 10 steps, each "
                         "ending in one published update")
    args = ap.parse_args(argv)

    cfg = reduce_recsys_for_smoke(RECSYS_ARCHS["dlrm-criteo"])
    batch_size = 256
    bus = MessageBus()

    with tempfile.TemporaryDirectory() as root:
        # -- offline phase: initial train + 2-model deploy ------------------
        model = RecsysModel(cfg, device=args.device, global_batch=batch_size)
        dev = model.device
        params = model.init(torch.Generator().manual_seed(0))
        tcfg = TrainConfig(learning_rate=1e-2)
        step = build_train_step(model, tcfg)
        opt_state = init_opt_state(params, tcfg)
        data = SyntheticCTR(cfg, batch_size)
        for i in range(10):
            params, opt_state, aux = step(params, opt_state,
                                          put_batch(data.batch(i), dev))

        # ONE storage backend, TWO deployed models: "online" gets the
        # update stream below, "static" is the same weights frozen: it
        # shares the PDB file store, the VolatileDB and the bus, yet
        # must never see the other model's updates
        pdb = PersistentDB(root)
        vdb = VolatileDB()
        dense = {k: v for k, v in params.items() if k != "embedding"}
        servers = {}
        for name in ("online", "static"):
            deploy_from_training(model, params, pdb, name)
            hps = HPS(name, cfg.tables, pdb, vdb=vdb, bus=bus,
                      cache_capacity=512, device=dev)
            # refresh is drained by hand below (the serve loops are not
            # started, so the refresh_budget never comes into play)
            servers[name] = InferenceServer(model, dense, hps)
        server = MultiModelServer(servers, vdb=vdb, pdb=pdb, bus=bus)

        probe = data.batch(777)
        p0 = {name: server.predict(name, probe["dense"], probe["cat"])
              for name in server.models}
        print("initial predictions: "
              + " ".join(f"{n}.mean={p.mean():.4f}" for n, p in p0.items()))

        # -- online phase: keep training, stream updates to ONE model -------
        producer = Producer(bus, "online")
        for i in range(10, 10 + 10 * args.windows):
            batch = data.batch(i)
            params, opt_state, aux = step(params, opt_state,
                                          put_batch(batch, dev))
            if i % 10 == 9:
                # dump incremental updates: rows touched this window
                logical = model.embedding.export_logical(
                    params["embedding"])
                g = model.embedding.groups["dp"]
                mega = logical["dp"].detach().cpu().numpy()
                for ti, (t, off) in enumerate(zip(g.tables, g.offsets)):
                    ids = np.unique(batch["cat"][:, ti, :].ravel())
                    ids = ids[ids >= 0]
                    producer.send(t.name, ids, mega[off + ids])
                producer.flush()
                # BOTH inference nodes poll the bus; only "online" has
                # matching topics, so only its L2/L3 rows change and only
                # its L1 rows go dirty; then drain the hotness-ordered
                # refresh backlog in bounded chunks, the same path the
                # serve loop drives between batches
                applied = {n: server[n].hps.apply_updates()
                           for n in server.models}
                refreshed = 0
                while server["online"].hps.refresh_backlog():
                    refreshed += server["online"].hps.refresh_step(
                        budget=128)
                p = {n: server.predict(n, probe["dense"], probe["cat"])
                     for n in server.models}
                drift = {n: float(np.abs(p[n] - p0[n]).mean())
                         for n in server.models}
                print(f"window @step {i}: applied {applied['online']} "
                      f"messages ({applied['static']} to static), "
                      f"refreshed {refreshed} L1 rows, drift "
                      + " ".join(f"{n}={d:.5f}" for n, d in drift.items()))
        assert drift["online"] > 0, "online updates must reach the server"
        assert drift["static"] == 0, \
            "the static model shares storage but must never drift"
        print("online updates propagated trainer -> bus -> VDB/PDB -> L1,"
              " static co-tenant untouched")

        # -- the full L1/L2/L3 serving picture, PER MODEL -------------------
        stats = server.stats()
        for name, st in stats.items():
            s = st["hps"]
            hit = np.mean(list(s["l1_hit_rate"].values()))
            l2 = s["l2"]
            l3_rows = sum(s["l3_fetches"]["rows"].values())
            own = {t: v for t, v in l2["tables"].items()
                   if t.startswith(name + "/")}
            print(f"[{name}] L1: hit_rate={hit:.3f} over "
                  f"{len(server[name].hps.caches)} cached tables; "
                  f"refresh: {s['refresh']['rows_refreshed']} rows in "
                  f"{s['refresh']['chunks']} chunks, backlog "
                  f"{s['refresh']['backlog']}")
            print(f"[{name}] L2 (shared store, own namespace): "
                  f"{sum(t['rows'] for t in own.values())} rows over "
                  f"{len(own)} tables x {l2['shards']} shard(s); "
                  f"L3: {sum(s['l3_fetches']['calls'].values())} fetches "
                  f"({l3_rows} rows) fell through to the PDB")
        server.close()
    return {"drift": drift, "stats": stats}


if __name__ == "__main__":
    main()
