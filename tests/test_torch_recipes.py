"""DCN, Wide&Deep and DeepFM through the port against the JAX package, on
the CPU, at ``build_model(smoke=True)`` sizes (6 tables of up to 1000
rows, D 16, deep tower 32-16).

Each comparison starts from one JAX ``init`` exported to numpy and carried
into the port by ``convert``:

* graphs: the JAX recipe's ``graph.json`` lowers in the port to the same
  ``recsys_config_hash`` (smoke and full width), the port's
  ``api.recipe_graph`` loads in the JAX package, and both equal the
  registry configs;
* layers: ``cross_apply`` and ``fm_second_order``, and the first-order
  term with a bf16 wide block (training) and an f32 one (serving); a
  program of declared ``cross`` and ``fm`` layers compiled in both;
* ``apply`` logits, the kernel path and the plain path: f32 <= 1e-5,
  bf16 <= 2e-2 (the DLRM bound: the frameworks round bf16 at other
  points, and XLA may fuse the cross layer's rounds);
* 5 ``fit`` steps through both packages' graph API: f32 losses and
  every parameter and table (the wide twins included) <= 1e-5, bf16
  losses <= 2e-2;
* bundles: a JAX-written one served by the port (f32 and int8 L1, the
  ``stream`` and ``sync`` engines; probabilities within 2e-2 of the JAX
  server, the f32 L1 reads of both HPSes bit-exact), and a port-written
  one served by the JAX package (within 2e-2 of the port's ``predict``);
* the logical checkpoint with its ``*_wide`` tables: saved by either
  package, loaded by the other bit for bit.

TF32 is pinned off (the f32 tier assumes f32 products).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro import api as japi
from repro.configs import dcn_criteo, deepfm_criteo, wdl_criteo
from repro.configs.base import recsys_config_hash as jhash
from repro.configs.registry import RECSYS_ARCHS as JARCHS
from repro.data.synthetic import SyntheticCTR as JSynthetic
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_server_from_config as jbuild
from repro.models.recsys import layers as jlayers
from repro.models.recsys.model import RecsysModel as JModel
from repro.models.recsys.model import export_logical_params as jexport
from repro.train.checkpoint import flatten_tree as jflatten

from repro_torch import api, convert
from repro_torch.configs import registry
from repro_torch.configs.base import recsys_config_hash
from repro_torch.launch.serve import build_server_from_config
from repro_torch.models.recsys import layers
from repro_torch.models.recsys.dense_graph import _first_order
from repro_torch.models.recsys.model import (
    RecsysModel, export_logical_params, import_logical_params)
from repro_torch.serve.server import InferenceServer
from repro_torch.train.trainer import put_batch

RECIPES = {"dcn-criteo": dcn_criteo, "wdl-criteo": wdl_criteo,
           "deepfm-criteo": deepfm_criteo}
ARCHS = tuple(RECIPES)
BATCH = 64
#: f32: the sum-order tier; bf16 logits and probabilities: the DLRM bound
TOL = {"f32": 1e-5, "bf16": 2e-2}
PROB_TOL = 2e-2


@pytest.fixture(autouse=True)
def _no_tf32():
    layers.pin_f32_matmul()


def _cfgs(arch, dtype="bf16"):
    """The smoke config of ``arch`` in both packages."""
    jcfg = RECIPES[arch].build_model(smoke=True).to_recsys_config()
    pcfg = registry.reduce_recsys_for_smoke(registry.RECSYS_ARCHS[arch])
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(pcfg, dtype=dtype))


def _pair(arch, dtype="bf16", use_kernels=True, seed=0):
    """The JAX model and the port's, the JAX init exported into both."""
    jcfg, pcfg = _cfgs(arch, dtype)
    mesh = make_test_mesh((1, 1))
    with mesh:
        jm = JModel(jcfg, mesh, global_batch=BATCH, use_kernels=use_kernels)
        jparams = jm.init(jax.random.PRNGKey(seed))
    pm = RecsysModel(pcfg, device="cpu", global_batch=BATCH,
                     use_kernels=use_kernels)
    tree = convert.state_from_flat(jflatten(jexport(jm, jparams)),
                                   device="cpu")
    return mesh, jm, jparams, pm, import_logical_params(pm, tree)


def _flat(tree):
    return {k: np.asarray(v) for k, v in jflatten(tree).items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# graphs and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_graphs_lower_to_the_jax_hash_both_ways(tmp_path, arch, smoke):
    jm = RECIPES[arch].build_model(smoke=smoke)
    want = jhash(jm.to_recsys_config())
    pm = api.Model.from_json(jm.graph_to_json(str(tmp_path / "j.json")))
    cfg = pm.to_recsys_config()
    assert recsys_config_hash(cfg) == want
    reg = registry.RECSYS_ARCHS[arch]
    if smoke:
        reg = registry.reduce_recsys_for_smoke(reg)
    assert cfg == reg
    assert recsys_config_hash(reg) == jhash(
        JARCHS[arch] if not smoke else jm.to_recsys_config())
    # the port's recipe_graph declares the same graph; JAX loads it
    path = api.recipe_graph(reg).graph_to_json(str(tmp_path / "p.json"))
    back = japi.Model.from_json(path)       # verifies the embedded hash
    assert jhash(back.to_recsys_config()) == want


def test_graph_errors_and_part_3b_still_raise():
    m = api.Model(name="bad")
    m.add(api.Input(dense_dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[10, 20], dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[10, 20], dim=1, top_name="wide"))
    m.add(api.DenseLayer("concat", ["dense", "emb"], ["flat"]))
    m.add(api.DenseLayer("mlp", ["flat"], ["deep"], units=(4, 1)))
    m.add(api.DenseLayer("fm", ["dense", "emb", "deep"], ["fm"]))
    m.add(api.DenseLayer("sigmoid", ["fm", "deep"], ["prob"]))
    with pytest.raises(api.GraphError, match="wide"):
        m.to_recsys_config()                # the wide group is never read
    # a wide graph that is none of the recipes lowers to model="graph"
    # with the wide branch, as in the reference, and loads
    m = api.Model(name="wide-generic")
    m.add(api.Input(dense_dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[10, 20], dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[10, 20], dim=1, top_name="wide"))
    m.add(api.DenseLayer("mlp", ["dense", "emb", "wide"], ["logit"],
                         units=(4, 1)))
    cfg = m.to_recsys_config()
    assert (cfg.model, cfg.wide_branch, cfg.extra_groups) == \
        ("graph", True, ())
    jm = japi.Model(name="wide-generic")
    jm.add(japi.Input(dense_dim=4))
    jm.add(japi.SparseEmbedding(vocab_sizes=[10, 20], dim=4))
    jm.add(japi.SparseEmbedding(vocab_sizes=[10, 20], dim=1,
                                top_name="wide"))
    jm.add(japi.DenseLayer("mlp", ["dense", "emb", "wide"], ["logit"],
                           units=(4, 1)))
    assert recsys_config_hash(cfg) == jhash(jm.to_recsys_config())
    m.compile(device="cpu")
    assert set(m.model.collections()) == {"embedding", "wide_embedding"}
    # two groups that are not a wide twin: the second is an extra group
    m = api.Model(name="two-groups")
    m.add(api.Input(dense_dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[10, 20], dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[10, 30], dim=1, top_name="w"))
    with pytest.raises(api.GraphError, match="terminal"):
        m.to_recsys_config()                # nothing reads the groups
    m.add(api.DenseLayer("concat", ["dense", "emb", "w"], ["flat"]))
    m.add(api.DenseLayer("mlp", ["flat"], ["logit"], units=(1,)))
    cfg = m.to_recsys_config()
    assert (cfg.model, cfg.wide_branch) == ("graph", False)
    assert [(g.name, g.dim, [t.name for t in g.tables])
            for g in cfg.extra_groups] == [("w", 1, ["w_f0", "w_f1"])]
    m.compile(device="cpu")
    assert m.model.group_columns() == {"embedding": (0, 2),
                                       "embedding@w": (2, 4)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_fm_and_first_order_match_jax(dtype):
    cd_j = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    cd_p = layers.compute_dtype(dtype)
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((32, 109)).astype(np.float32)
    jp = jlayers.cross_init(jax.random.PRNGKey(1), 109, 6)
    pp = convert.dense_from_flat(jflatten(jp), device="cpu")
    want = np.asarray(jlayers.cross_apply(jp, jnp.asarray(x0),
                                          compute_dtype=cd_j))
    got = layers.cross_apply(pp, torch.from_numpy(x0),
                             compute_dtype=cd_p).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])

    emb = rng.standard_normal((32, 6, 16)).astype(np.float32)
    emb_j, emb_p = jnp.asarray(emb).astype(cd_j), \
        torch.from_numpy(emb).to(cd_p)
    np.testing.assert_allclose(
        layers.fm_second_order(emb_p).numpy(),
        np.asarray(jlayers.fm_second_order(emb_j)), rtol=1e-5, atol=1e-5)

    # the first-order term as the reference's program computes it
    # (dense_graph.py, op "first_order"), with the wide block in the
    # compute dtype (training) and in f32 (served by the HPS)
    dense = rng.standard_normal((32, 13)).astype(np.float32)
    wide = (rng.standard_normal((32, 6, 1)) * 0.3).astype(np.float32)
    w = (rng.standard_normal(13) * 0.01).astype(np.float32)
    b = np.float32(0.25)
    for wj, wp in ((jnp.asarray(wide).astype(cd_j),
                    torch.from_numpy(wide).to(cd_p)),
                   (jnp.asarray(wide), torch.from_numpy(wide))):
        want = np.asarray(wj.sum(axis=(1, 2)) + jnp.asarray(dense)
                          @ jnp.asarray(w) + jnp.asarray(b))
        got = _first_order(torch.from_numpy(dense), wp,
                           torch.from_numpy(w), torch.tensor(b)).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_declared_cross_and_fm_layers_match_jax(dtype):
    """The ``cross`` and ``fm`` ops as a graph declares them (the canonical
    DeepFM program runs ``fm`` as ``first_order`` + ``fm_second``): one
    program compiled in both packages from the same specs, the fm bottoms
    given out of order, JAX's per-layer init carried across."""
    from repro.models.recsys import dense_graph as jdg
    from repro_torch.models.recsys import dense_graph as pdg
    cd_j = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    cd_p = layers.compute_dtype(dtype)

    def specs(mod):
        return [mod.LayerSpec("concat", ("dense", "emb"), "flat"),
                mod.LayerSpec("cross", ("flat",), "crossed", num_layers=3),
                mod.LayerSpec("mlp", ("crossed",), "deep_out",
                              units=(8, 1)),
                mod.LayerSpec("fm", ("emb", "dense", "wide"), "fm_out"),
                mod.LayerSpec("sigmoid", ("fm_out", "deep_out"), "prob")]

    shape = dict(dense_name="dense", num_dense=13, emb_name="emb",
                 num_tables=6, emb_dim=16, wide_name="wide")
    jprog = jdg.compile_layers(specs(jdg), **shape)
    pprog = pdg.compile_layers(specs(pdg), **shape)
    params = jprog.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(9)
    dense = rng.standard_normal((32, 13)).astype(np.float32)
    emb = (rng.standard_normal((32, 6, 16)) * 0.3).astype(np.float32)
    wide = (rng.standard_normal((32, 6, 1)) * 0.3).astype(np.float32)
    want = np.asarray(jprog.apply(params, jprog.make_env(
        jnp.asarray(dense), jnp.asarray(emb), jnp.asarray(wide), cd_j),
        cd_j))
    got = pprog.apply(
        convert.state_from_flat(jflatten(params), device="cpu"),
        pprog.make_env(torch.from_numpy(dense), torch.from_numpy(emb),
                       torch.from_numpy(wide), cd_p), cd_p).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_apply_matches_jax(arch, dtype, use_kernels):
    mesh, jm, jparams, pm, pparams = _pair(arch, dtype, use_kernels)
    assert set(pparams) == set(jparams)
    assert ("wide_embedding" in pparams) == (arch != "dcn-criteo")
    batch = JSynthetic(jm.cfg, BATCH, seed=3).batch(0)
    with mesh:
        want = np.asarray(jax.jit(jm.apply)(jparams, _jbatch(batch)))
    with torch.no_grad():
        got = pm.apply(pparams, put_batch(batch, "cpu")).numpy()
    assert got.shape == want.shape == (BATCH,)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("arch", ["wdl-criteo", "deepfm-criteo"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_dense_with_an_f32_wide_block_matches_jax(arch, dtype):
    """The served path: the HPS delivers the wide block in f32."""
    mesh, jm, jparams, pm, pparams = _pair(arch, dtype)
    rng = np.random.default_rng(6)
    dense = rng.standard_normal((BATCH, 13)).astype(np.float32)
    emb = (rng.standard_normal((BATCH, 6, 16)) * 0.1).astype(np.float32)
    wide = (rng.standard_normal((BATCH, 6, 1)) * 0.1).astype(np.float32)
    with mesh:
        want = np.asarray(jm.apply_dense(jparams, jnp.asarray(dense),
                                         jnp.asarray(emb), jnp.asarray(wide)))
    with torch.no_grad():
        got = pm.apply_dense(pparams, torch.from_numpy(dense),
                             torch.from_numpy(emb),
                             torch.from_numpy(wide)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    with pytest.raises(ValueError, match="wide"):
        pm.apply_dense(pparams, torch.from_numpy(dense),
                       torch.from_numpy(emb))


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

def _graphs(arch, dtype, lr=1e-2):
    """Both packages' graph of ``arch``, compiled, on one JAX init."""
    jcfg, pcfg = _cfgs(arch, dtype)
    solver = dict(batch_size=BATCH, lr=lr, weight_decay=0.01)
    j = RECIPES[arch].build_model(smoke=True, solver=japi.Solver(**solver))
    p = api.recipe_graph(dataclasses.replace(pcfg, dtype="bf16"),
                         solver=api.Solver(**solver))
    j.compile()
    p.compile(device="cpu")
    # the graph API lowers to the default bf16; set the dtype under test
    j.cfg = jcfg
    with j.mesh:
        j._model = JModel(jcfg, j.mesh, global_batch=BATCH)
        j._params = j._model.init(jax.random.PRNGKey(2))
    p.cfg = pcfg
    p._model = RecsysModel(pcfg, device="cpu", global_batch=BATCH)
    p._params = import_logical_params(p.model, convert.state_from_flat(
        jflatten(jexport(j.model, j._params)), device="cpu"))
    return j, p


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fit_matches_jax(arch, dtype):
    j, p = _graphs(arch, dtype)
    data = JSynthetic(j.cfg, BATCH, seed=4).batch
    jh = j.fit(data, steps=5)
    ph = p.fit(data, steps=5)
    jl, pl = [h["loss"] for h in jh], [h["loss"] for h in ph]
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == "bf16":
        return
    with j.mesh:
        want = _flat(jexport(j.model, j.params))
    got = convert.state_to_flat(export_logical_params(p.model, p.params))
    assert set(got) == set(want)
    assert any(k.startswith("wide_embedding/") for k in got) == \
        (arch != "dcn-criteo")
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k], v, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=k)


# ---------------------------------------------------------------------------
# bundles, both ways
# ---------------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """``(arch, payload) -> (ps.json, JAX model, JAX server, requests, the
    JAX server's predictions)``, each JAX bundle deployed once from a JAX
    init and served by the JAX package."""
    cache = {}

    def get(arch, payload_dtype):
        if arch not in cache:
            d = str(tmp_path_factory.mktemp(arch))
            m = RECIPES[arch].build_model(smoke=True)
            m.compile()
            with m.mesh:
                m._params = m.model.init(jax.random.PRNGKey(0))
            m.deploy(d, cache_capacity=64)
            cache[arch] = (os.path.join(d, "ps.json"), m,
                           _requests(m.cfg, 3, 48, seed=11))
        key = (arch, payload_dtype)
        if key not in cache:
            ps, m, reqs = cache[arch]
            jserver, _ = jbuild(ps, payload_dtype=payload_dtype)
            cache[key] = (jserver, [jserver.predict(d, c) for d, c in reqs])
        ps, m, reqs = cache[arch]
        return (ps, m, *cache[key], reqs)

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
@pytest.mark.parametrize("engine", ["stream", "sync"])
def test_port_serves_jax_bundle(jax_served, arch, payload_dtype, engine):
    ps, jm, jserver, want, reqs = jax_served(arch, payload_dtype)
    built, graph = build_server_from_config(ps, device="cpu",
                                            payload_dtype=payload_dtype)
    assert graph.name == jm.name
    assert (built.wide_hps is not None) == (arch != "dcn-criteo")
    server = InferenceServer(built.model, built.dense_params, built.hps,
                             wide_hps=built.wide_hps, engine=engine)
    for (d, c), w in zip(reqs, want):
        np.testing.assert_allclose(server.predict(d, c), w, rtol=PROB_TOL,
                                   atol=PROB_TOL)
    server.start()
    try:
        outs = [h.get(timeout=120) for h in
                [server.submit(d, c) for d, c in reqs]]
    finally:
        server.close()
    for o, w in zip(outs, want):
        assert not isinstance(o, Exception), o
        assert o.shape == w.shape == (48,)
        np.testing.assert_allclose(o, w, rtol=PROB_TOL, atol=PROB_TOL)
    assert server.counters()["requests_delivered"] == len(reqs)
    if payload_dtype == "f32":              # the L1 reads: bit-exact
        _, c = reqs[0]
        pairs = [(built.hps, jserver.hps)]
        if built.wide_hps is not None:
            pairs.append((built.wide_hps, jserver.wide_hps))
        for ph, jh in pairs:
            np.testing.assert_array_equal(ph.lookup(c).numpy(),
                                          np.asarray(jh.lookup(c)))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_serves_port_bundle(tmp_path, arch):
    _, pcfg = _cfgs(arch)
    m = api.recipe_graph(pcfg, solver=api.Solver(batch_size=BATCH, lr=1e-2))
    m.compile(device="cpu")
    m.fit(steps=2)
    server = m.deploy(str(tmp_path), cache_capacity=32)
    reqs = _requests(m.cfg, 2, 40, seed=8)
    try:
        port_preds = [server.predict(d, c) for d, c in reqs]
    finally:
        server.close()
    jserver, jm = jbuild(str(tmp_path / "ps.json"))
    assert jhash(jm.cfg) == recsys_config_hash(m.cfg)
    assert (jserver.wide_hps is not None) == (arch != "dcn-criteo")
    for (d, c), pp in zip(reqs, port_preds):
        want = m.predict({"dense": d, "cat": c})
        got = jserver.predict(d, c)
        assert np.isfinite(got).all() and got.shape == (40,)
        np.testing.assert_allclose(got, want, rtol=PROB_TOL, atol=PROB_TOL)
        np.testing.assert_allclose(pp, want, rtol=PROB_TOL, atol=PROB_TOL)


# ---------------------------------------------------------------------------
# the logical checkpoint with the wide tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_round_trip_between_packages(tmp_path, arch):
    _, pcfg = _cfgs(arch)
    p = api.recipe_graph(pcfg, solver=api.Solver(batch_size=BATCH, lr=1e-2))
    p.compile(device="cpu")
    p.fit(steps=2)
    p.save(str(tmp_path / "port"))
    want = convert.state_to_flat(export_logical_params(p.model, p.params))
    assert any(k.startswith("wide_embedding/") for k in want) == \
        (arch != "dcn-criteo")
    j = japi.Model.load(str(tmp_path / "port"))
    with j.mesh:
        got = _flat(jexport(j.model, j.params))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = api.Model.load(str(tmp_path / "port"), device="cpu")
    again = convert.state_to_flat(export_logical_params(back.model,
                                                        back.params))
    for k, v in want.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    # and the other way: JAX saves, the port loads and keeps training
    j.fit(steps=1)
    j.save(str(tmp_path / "jax"))
    with j.mesh:
        want = _flat(jexport(j.model, j.params))
    q = api.Model.load(str(tmp_path / "jax"), device="cpu")
    got = convert.state_to_flat(export_logical_params(q.model, q.params))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    req = JSynthetic(j.cfg, 32).batch(7)
    np.testing.assert_allclose(q.predict(req), j.predict(req),
                               rtol=PROB_TOL, atol=PROB_TOL)
    assert np.isfinite([h["loss"] for h in q.fit(steps=1)]).all()
