"""Novel architectures through the generic dense-graph compiler (the twin
of ``examples/novel_archs.py``).

The graph API does not pattern-match a menu of recipes: any valid layer
DAG compiles into a dense-graph program and runs through the same
training, deployment and serving stack as the paper models. This example
drives TWO architectures that exist nowhere in the codebase as
model-specific code:

  * a two-tower residual model (``configs/twotower_criteo.py``):
    multiply / reduce_sum dot-product logit + residual MLP head,
  * a DCN-v2-style parallel cross+deep hybrid
    (``configs/crossdeep_criteo.py``): per-branch logit heads plus a
    sliced low-order linear branch,

each: declared -> compiled -> trained -> JSON round-tripped -> deployed
to a relocatable bundle -> served from the REBUILT server (bit-exact
with the in-process deploy) -> exported and replayed in pure numpy.

Run:  PYTHONPATH=src python -m repro_torch.examples.novel_archs \
          [--device cpu] [--steps 15]
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.api import Model, Solver
from repro_torch.configs import crossdeep_criteo, twotower_criteo
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.export import export_recsys, load_exported, run_exported
from repro_torch.launch.serve import build_server_from_config


def drive(build_model, steps: int = 15, batch: int = 64,
          device=None) -> dict:
    m = build_model(smoke=True, solver=Solver(batch_size=batch, lr=1e-2))
    cfg = m.to_recsys_config()
    print(f"\n=== {m.name}: lowers to model={cfg.model!r} "
          f"({len(cfg.dense_graph) - 1} compiled layers) ===")
    m.compile(device=device)
    m.summary()
    data = SyntheticCTR(m.cfg, batch)
    hist = m.fit(data.batch, steps=steps)
    print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    req = data.batch(990)
    want = m.predict(req)

    with tempfile.TemporaryDirectory() as root:
        # JSON round-trip reproduces the exact same lowered config
        gpath = os.path.join(root, "graph.json")
        m.graph_to_json(gpath)
        assert Model.from_json(gpath).to_recsys_config() == cfg

        # deploy -> rebuild from the bundle alone -> bit-exact serving
        dep = os.path.join(root, "dep")
        server = m.deploy(dep, cache_capacity=512)
        rebuilt, _ = build_server_from_config(
            os.path.join(dep, "ps.json"), device=device)
        try:
            got = server.predict(req["dense"], req["cat"])
            got2 = rebuilt.predict(req["dense"], req["cat"])
        finally:
            server.close()
            rebuilt.close()
        np.testing.assert_array_equal(got2, got)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        print(f"served {len(got2)} predictions from the rebuilt bundle "
              "(bit-exact with in-process deploy)")

        # portable export replays under pure numpy
        exp = export_recsys(m.model, dict(m.params),
                            os.path.join(root, "exp"), m.name)
        graph, weights = load_exported(exp)
        np_preds = run_exported(graph, weights, req)
        np.testing.assert_allclose(np_preds, want, rtol=2e-2, atol=2e-2)
        print(f"numpy executor parity over {len(graph['nodes'])} "
              "portable nodes")
    return {"name": m.name, "losses": [h["loss"] for h in hist]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=15)
    args = ap.parse_args(argv)
    out = [drive(b.build_model, args.steps, device=args.device)
           for b in (twotower_criteo, crossdeep_criteo)]
    print("\nboth novel graphs trained, round-tripped, deployed, "
          "served and exported with zero per-arch lowering code")
    return out


if __name__ == "__main__":
    main()
