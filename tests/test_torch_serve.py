"""Serving interchange between the port and the JAX package.

- A JAX-written ``graph.json`` of the DLRM recipe (full and smoke) lowers
  in the port to the same ``recsys_config_hash``, and a port-written one
  loads in the JAX package.
- With the dense weights carried across by ``convert``, the port's
  ``apply_dense`` equals ``RecsysModel.apply_dense``: <= 1e-5 under an f32
  config; under the default bf16 config the logits agree within 2e-2
  (the f32 sums run in another order, so a bf16 rounding of an
  intermediate activation can land one ulp apart).
- A server the port rebuilds from a JAX-deployed smoke bundle predicts
  what the JAX server predicts (``predict`` and ``submit``), and the JAX
  package serves a port-written bundle; probabilities within 2e-2, the
  bound ``examples/quickstart.py`` holds the JAX server to.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import dlrm_criteo as jrecipe
from repro.configs.base import recsys_config_hash as jhash
from repro.configs.registry import RECSYS_ARCHS, reduce_recsys_for_smoke
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_server_from_config as jbuild
from repro.models.recsys.model import RecsysModel as JModel
from repro.train.checkpoint import flatten_tree
from repro_torch import api
from repro_torch.configs import registry
from repro_torch.configs.base import recsys_config_from_dict, recsys_config_hash
from repro_torch.convert import dense_from_flat, dense_to_flat
from repro_torch.launch.serve import build_server_from_config
from repro_torch.models.recsys.model import RecsysModel
from repro_torch.serve.server import InferenceServer, write_bundle

PROB_TOL = 2e-2


def _requests(cfg, n, b, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dense = rng.standard_normal((b, cfg.num_dense_features)).astype(
            np.float32)
        cat = np.stack([rng.integers(0, t.vocab_size, (b, 1))
                        for t in cfg.tables], axis=1).astype(np.int32)
        out.append((dense, cat))
    return out


# ---------------------------------------------------------------------------
# graph.json interchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_jax_graph_lowers_to_same_hash(tmp_path, smoke):
    jm = jrecipe.build_model(smoke=smoke)
    path = jm.graph_to_json(str(tmp_path / "graph.json"))
    pm = api.Model.from_json(path)
    cfg = pm.to_recsys_config()
    assert recsys_config_hash(cfg) == jhash(jm.to_recsys_config())
    want = RECSYS_ARCHS["dlrm-criteo"]
    if smoke:
        want = dataclasses.replace(
            reduce_recsys_for_smoke(want), name="dlrm-criteo-smoke")
        assert cfg.name == "dlrm-criteo-smoke"
    assert recsys_config_hash(cfg) == jhash(
        dataclasses.replace(want, name=cfg.name))


@pytest.mark.parametrize("smoke", [True, False])
def test_port_graph_loads_in_jax(tmp_path, smoke):
    from repro.api import Model as JApiModel
    cfg = registry.dlrm_criteo
    if smoke:
        cfg = registry.reduce_recsys_for_smoke(cfg)
    g = api.dlrm_graph(cfg)
    path = g.graph_to_json(str(tmp_path / "graph.json"))
    jm = JApiModel.from_json(path)          # verifies the embedded hash
    assert jhash(jm.to_recsys_config()) == recsys_config_hash(cfg)
    with open(path) as f:
        assert json.load(f)["config_hash"] == recsys_config_hash(cfg)


def test_registry_config_hash_matches_jax():
    assert recsys_config_hash(registry.dlrm_criteo) == \
        jhash(RECSYS_ARCHS["dlrm-criteo"])
    assert recsys_config_hash(
        registry.reduce_recsys_for_smoke(registry.dlrm_criteo)) == \
        jhash(reduce_recsys_for_smoke(RECSYS_ARCHS["dlrm-criteo"]))
    d = json.loads(json.dumps(dataclasses.asdict(registry.dlrm_criteo)))
    d = {k: v for k, v in d.items()
         if k not in ("dense_graph", "wide_branch", "extra_groups")}
    assert recsys_config_from_dict(d) == registry.dlrm_criteo


def test_other_graphs_are_not_ported(tmp_path):
    # a generic graph (multiply, reduce_sum, add, relu) written by JAX
    # now loads in the port, at the reference's hash, and compiles
    from repro.configs import twotower_criteo
    jm = twotower_criteo.build_model(smoke=True)
    path = jm.graph_to_json(str(tmp_path / "g.json"))
    pm = api.Model.from_json(path)          # verifies the embedded hash
    cfg = pm.to_recsys_config()
    assert cfg.model == "graph"
    assert recsys_config_hash(cfg) == jhash(jm.to_recsys_config())
    pm.compile(device="cpu")
    assert {n.op for n in pm.model.program.nodes} >= {
        "multiply", "reduce_sum", "add", "relu"}
    m = api.Model(name="bad")
    m.add(api.Input(dense_dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[10], dim=4))
    m.add(api.DenseLayer("mlp", ["dense"], ["bot"], units=(4,),
                         final_activation=True))
    m.add(api.DenseLayer("dot_interaction", ["bot", "nope"], ["x"]))
    with pytest.raises(api.GraphError, match="nope"):
        m.to_recsys_config()


# ---------------------------------------------------------------------------
# apply_dense against the JAX model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_apply_dense_matches_jax(dtype, tol, use_kernels):
    jcfg = dataclasses.replace(
        reduce_recsys_for_smoke(RECSYS_ARCHS["dlrm-criteo"]), dtype=dtype)
    pcfg = dataclasses.replace(
        registry.reduce_recsys_for_smoke(registry.dlrm_criteo), dtype=dtype)
    mesh = make_test_mesh((1, 1))
    with mesh:
        jm = JModel(jcfg, mesh, global_batch=32)
        params = jm.init(jax.random.PRNGKey(3))
    flat = flatten_tree({k: v for k, v in params.items()
                         if k in ("bottom", "top")})
    dense_p = dense_from_flat(flat, device="cpu")
    assert set(dense_to_flat(dense_p)) == set(flat)
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((32, 13)).astype(np.float32)
    emb = (rng.standard_normal((32, 6, 16)) * 0.5).astype(np.float32)
    with mesh:
        want = np.asarray(jm.apply_dense(params, jnp.asarray(dense),
                                         jnp.asarray(emb)))
    pm = RecsysModel(pcfg, device="cpu", use_kernels=use_kernels)
    got = pm.apply_dense(dense_p, torch.from_numpy(dense),
                         torch.from_numpy(emb)).numpy()
    assert got.shape == (32,)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# bundles, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_bundle"))
    m = jrecipe.build_model(smoke=True)
    m.compile()
    with m.mesh:
        m._params = m.model.init(jax.random.PRNGKey(0))
    m.deploy(d, cache_capacity=64)
    return os.path.join(d, "ps.json"), m


@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_port_serves_jax_bundle(jax_bundle, payload_dtype):
    ps, jm = jax_bundle
    jserver, _ = jbuild(ps, payload_dtype=payload_dtype)
    server, graph = build_server_from_config(ps, device="cpu",
                                             payload_dtype=payload_dtype)
    assert graph.name == jm.name
    reqs = _requests(jm.cfg, 4, 48, seed=11)
    want = [jserver.predict(d, c) for d, c in reqs]
    got = [server.predict(d, c) for d, c in reqs]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (48,)
        np.testing.assert_allclose(g, w, rtol=PROB_TOL, atol=PROB_TOL)
    server.start()
    try:
        handles = [server.submit(d, c) for d, c in reqs]
        outs = [h.get(timeout=120) for h in handles]
    finally:
        server.close()
    for o, w in zip(outs, want):
        assert not isinstance(o, Exception), o
        np.testing.assert_allclose(o, w, rtol=PROB_TOL, atol=PROB_TOL)
    assert server.counters()["requests_delivered"] == len(reqs)
    with server._admit_lock:
        assert server._closed
    rejected = server.submit(*reqs[0]).get(timeout=5)
    assert type(rejected).__name__ == "ServerOverloaded"
    # f32 payloads: the L1 read itself is bit-exact with the JAX HPS
    if payload_dtype == "f32":
        d, c = _requests(jm.cfg, 1, 16, seed=12)[0]
        np.testing.assert_array_equal(
            server.hps.lookup(c).numpy(), np.asarray(jserver.hps.lookup(c)))


@pytest.mark.parametrize("engine", ["stream", "sync"])
def test_jax_serves_port_bundle(tmp_path, engine):
    cfg = registry.reduce_recsys_for_smoke(registry.dlrm_criteo)
    graph = api.dlrm_graph(cfg)
    params = RecsysModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(7))
    rng = np.random.default_rng(7)
    tables = {t.name: (rng.standard_normal((t.vocab_size, t.dim)) * 0.3)
              .astype(np.float32) for t in cfg.tables}
    hcfg = write_bundle(str(tmp_path), graph, params, tables,
                        cache_capacity=32)
    assert hcfg.config_hash == recsys_config_hash(cfg)
    ps = str(tmp_path / "ps.json")
    jserver, jm = jbuild(ps)
    assert jhash(jm.cfg) == hcfg.config_hash
    built, _ = build_server_from_config(ps, device="cpu")
    server = InferenceServer(built.model, built.dense_params, built.hps,
                             engine=engine)
    reqs = _requests(cfg, 3, 40, seed=8)
    server.start()
    try:
        handles = [server.submit(d, c) for d, c in reqs]
        outs = [h.get(timeout=120) for h in handles]
    finally:
        server.close()
    for (d, c), o in zip(reqs, outs):
        assert not isinstance(o, Exception), o
        want = jserver.predict(d, c)
        assert np.isfinite(o).all() and o.shape == (40,)
        np.testing.assert_allclose(o, want, rtol=PROB_TOL, atol=PROB_TOL)
