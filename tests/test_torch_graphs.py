"""Generic dense graphs and N embedding groups through the port against the
JAX package, on the CPU, at ``build_model(smoke=True)`` sizes.

The graphs: the three graph recipes (``twotower-criteo``: multiply,
reduce_sum, add, relu; ``crossdeep-criteo``: slice and a three-logit
terminal; ``neumf-criteo``: three embedding groups at D 16, 8 and 4) and a
"wide-generic" graph (a dim-1 twin group read by an mlp: ``model="graph"``
with ``wide_branch``). Each comparison starts from one JAX ``init``
exported to numpy and carried into the port by ``convert``:

* each of the five new ops alone, one program compiled in both packages
  (f32 <= 1e-5);
* ``recsys_config_hash`` of every graph equal to the reference's, both
  ways through ``graph.json``, and the port's ``init`` tree the
  reference's (keys and shapes);
* ``apply`` logits, kernel path and plain path (f32 <= 1e-5);
* 5 ``fit`` steps (f32 losses and every parameter <= 1e-5);
* the trainer's checkpoint (params and the optimizers' state, the
  row-wise AdaGrad's per group) written by either package and resumed by
  the other (f32 losses <= 1e-5), and ``Model.save`` loaded bit for bit;
* bundles: a JAX-written one served by the port (f32 and int8 L1, one HPS
  per table set; probabilities within 2e-2 of the JAX server, the f32 L1
  reads of every HPS bit-exact), and a port-written one by the JAX
  package (within 2e-2 of the port's ``predict``);
* ``GraphError`` for a table name in two groups and an extra group that
  shadows a param key;
* the portable export: the port's artifact run by the port's and the
  reference's ``run_exported``, the reference's by the port's, all within
  1e-5 of the f32 forward.

TF32 is pinned off (the f32 tier assumes f32 products).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from repro import api as japi
from repro import export as jexp
from repro.configs import crossdeep_criteo as jcrossdeep
from repro.configs import neumf_criteo as jneumf
from repro.configs import twotower_criteo as jtwotower
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import recsys_config_hash as jhash
from repro.data.synthetic import SyntheticCTR as JSynthetic
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_server_from_config as jbuild
from repro.models.recsys import dense_graph as jdg
from repro.models.recsys.model import RecsysModel as JModel
from repro.models.recsys.model import export_logical_params as jexport
from repro.train.checkpoint import flatten_tree as jflatten
from repro.train.trainer import Trainer as JTrainer

from repro_torch import api, convert, export
from repro_torch.configs import (
    crossdeep_criteo, neumf_criteo, registry, twotower_criteo)
from repro_torch.configs.base import TrainConfig, recsys_config_hash
from repro_torch.launch.serve import build_server_from_config
from repro_torch.models.recsys import dense_graph as pdg
from repro_torch.models.recsys import layers
from repro_torch.models.recsys.model import (
    RecsysModel, export_logical_params, import_logical_params)
from repro_torch.serve.server import InferenceServer
from repro_torch.train.trainer import Trainer, put_batch

BATCH = 64
TOL = 1e-5
PROB_TOL = 2e-2


def wide_generic(mod, *, smoke=True, solver=None):
    """A wide graph that is none of the recipes: the dim-1 twin group
    read, with the dense features and the deep group, by one mlp."""
    m = mod.Model(solver or mod.Solver(), name="wide-generic")
    m.add(mod.Input(dense_dim=4))
    m.add(mod.SparseEmbedding(vocab_sizes=[10, 20], dim=4))
    m.add(mod.SparseEmbedding(vocab_sizes=[10, 20], dim=1, top_name="wide"))
    m.add(mod.DenseLayer("mlp", ["dense", "emb", "wide"], ["logit"],
                         units=(4, 1)))
    return m


#: arch -> (the reference's build_model, the port's)
BUILDERS = {
    "twotower-criteo": (jtwotower.build_model, twotower_criteo.build_model),
    "crossdeep-criteo": (jcrossdeep.build_model,
                         crossdeep_criteo.build_model),
    "neumf-criteo": (jneumf.build_model, neumf_criteo.build_model),
    "wide-generic": (functools.partial(wide_generic, japi),
                     functools.partial(wide_generic, api)),
}
ARCHS = tuple(BUILDERS)


@pytest.fixture(autouse=True)
def _no_tf32():
    layers.pin_f32_matmul()


def _cfgs(arch, dtype="f32"):
    jb, pb = BUILDERS[arch]
    return (dataclasses.replace(jb(smoke=True).to_recsys_config(),
                                dtype=dtype),
            dataclasses.replace(pb(smoke=True).to_recsys_config(),
                                dtype=dtype))


def _pair(arch, dtype="f32", use_kernels=True, seed=0):
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
# the new ops, alone
# ---------------------------------------------------------------------------

OP_SPECS = {
    "add": [("mlp", ("dense",), "a", {"units": (8,)}),
            ("mlp", ("emb",), "b", {"units": (8,)}),
            ("add", ("a", "b"), "x", {}),
            ("mlp", ("x",), "logit", {"units": (1,)})],
    "multiply": [("mlp", ("dense",), "a", {"units": (8,)}),
                 ("mlp", ("emb",), "b", {"units": (8,)}),
                 ("multiply", ("a", "b"), "x", {}),
                 ("mlp", ("x",), "logit", {"units": (1,)})],
    "relu": [("concat", ("dense", "emb"), "flat", {}),
             ("relu", ("flat",), "x", {}),
             ("mlp", ("x",), "logit", {"units": (1,)})],
    "slice": [("concat", ("dense", "emb"), "flat", {}),
              ("slice", ("flat",), "x", {"start": 3, "stop": 40}),
              ("mlp", ("x",), "logit", {"units": (1,)})],
    "reduce_sum": [("concat", ("dense", "emb"), "flat", {}),
                   ("reduce_sum", ("flat",), "x", {}),
                   ("mlp", ("dense",), "h", {"units": (1,)}),
                   ("sigmoid", ("x", "h"), "prob", {})],
}


@pytest.mark.parametrize("op", sorted(OP_SPECS))
def test_op_matches_jax(op):
    """One program around ``op`` compiled in both packages from the same
    specs, JAX's per-layer init carried across, f32."""

    def specs(mod):
        return [mod.LayerSpec(t, b, top, **kw)
                for t, b, top, kw in OP_SPECS[op]]

    shape = dict(dense_name="dense", num_dense=13, emb_name="emb",
                 num_tables=6, emb_dim=16)
    jprog = jdg.compile_layers(specs(jdg), **shape)
    pprog = pdg.compile_layers(specs(pdg), **shape)
    assert [n.op for n in pprog.nodes] == [n.op for n in jprog.nodes]
    assert pprog.shapes == jprog.shapes
    params = jprog.init(jax.random.PRNGKey(4))
    got_tree = pprog.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in convert.state_to_flat(got_tree).items()} \
        == {k: v.shape for k, v in _flat(params).items()}
    rng = np.random.default_rng(9)
    dense = rng.standard_normal((32, 13)).astype(np.float32)
    emb = (rng.standard_normal((32, 6, 16)) * 0.3).astype(np.float32)
    want = np.asarray(jprog.apply(params, jprog.make_env(
        jnp.asarray(dense), jnp.asarray(emb), None, jnp.float32),
        jnp.float32))
    got = pprog.apply(
        convert.state_from_flat(jflatten(params), device="cpu"),
        pprog.make_env(torch.from_numpy(dense), torch.from_numpy(emb), None,
                       torch.float32), torch.float32).numpy()
    assert got.shape == want.shape == (32,)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# graphs, configs, errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_config_hash_matches_jax_both_ways(tmp_path, arch, smoke):
    jb, pb = BUILDERS[arch]
    jm, pm = jb(smoke=smoke), pb(smoke=smoke)
    jcfg, pcfg = jm.to_recsys_config(), pm.to_recsys_config()
    assert pcfg.model == "graph"
    assert recsys_config_hash(pcfg) == jhash(jcfg)
    assert [t.name for t in pcfg.all_tables] == \
        [t.name for t in jcfg.all_tables]
    # JAX graph.json -> port, port graph.json -> JAX (each verifies the
    # embedded hash)
    back = api.Model.from_json(jm.graph_to_json(str(tmp_path / "j.json")))
    assert back.to_recsys_config() == pcfg
    jback = japi.Model.from_json(pm.graph_to_json(str(tmp_path / "p.json")))
    assert jhash(jback.to_recsys_config()) == jhash(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_model_rebuilds_a_config(tmp_path, arch):
    """``api.recipe_graph`` of a graph config declares its graph from the
    config alone (a vocabulary cut included), at the reference's hash."""
    import importlib
    if arch in registry.RECSYS_RECIPES:
        mod = importlib.import_module(registry.RECSYS_RECIPES[arch])
        assert mod.ARCH_ID == arch
    cfg = BUILDERS[arch][1](smoke=False).to_recsys_config()
    cut = lambda ts: tuple(dataclasses.replace(
        t, vocab_size=min(t.vocab_size, 500)) for t in ts)
    for c in (cfg, dataclasses.replace(
            cfg, tables=cut(cfg.tables),
            extra_groups=tuple(dataclasses.replace(g, tables=cut(g.tables))
                               for g in cfg.extra_groups))):
        m = api.recipe_graph(c)
        assert m.to_recsys_config() == c
        j = japi.Model.from_json(m.graph_to_json(str(tmp_path / "g.json")))
        assert jhash(j.to_recsys_config()) == recsys_config_hash(c)


def test_duplicate_table_names_across_groups_raise():
    m = api.Model(name="dup")
    m.add(api.Input(dense_dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[30], dim=8, top_name="a",
                              table_names=["t"]))
    m.add(api.SparseEmbedding(vocab_sizes=[30], dim=4, top_name="b",
                              table_names=["t"]))
    m.add(api.DenseLayer("concat", ["dense", "a", "b"], ["flat"]))
    m.add(api.DenseLayer("mlp", ["flat"], ["logit"], units=(1,)))
    with pytest.raises(api.GraphError, match="globally unique"):
        m.to_recsys_config()


@pytest.mark.parametrize("top", ["wide_embedding", "embedding@b"])
def test_extra_group_may_not_shadow_a_param_key(top):
    m = api.Model(name="shadow")
    m.add(api.Input(dense_dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=[30], dim=8, top_name="a"))
    m.add(api.SparseEmbedding(vocab_sizes=[30], dim=4, top_name=top))
    with pytest.raises(api.GraphError, match="reserved"):
        m.to_recsys_config()


# ---------------------------------------------------------------------------
# forward and fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_apply_matches_jax(arch, use_kernels):
    mesh, jm, jparams, pm, pparams = _pair(arch, use_kernels=use_kernels)
    # the port's own init: the reference's tree and shapes
    own = convert.state_to_flat(export_logical_params(pm, pm.init()))
    want_shapes = {k: v.shape for k, v in _flat(jexport(jm, jparams)).items()}
    assert {k: v.shape for k, v in own.items()} == want_shapes
    assert set(pm.collections()) == set(jm.collections())
    assert pm.group_columns() == jm.group_columns()
    batch = JSynthetic(jm.cfg, BATCH, seed=3).batch(0)
    with mesh:
        want = np.asarray(jax.jit(jm.apply)(jparams, _jbatch(batch)))
    with torch.no_grad():
        got = pm.apply(pparams, put_batch(batch, "cpu")).numpy()
    assert got.shape == want.shape == (BATCH,)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _graphs(arch, lr=1e-2):
    """Both packages' graph of ``arch`` at f32, compiled, on one JAX
    init."""
    jcfg, pcfg = _cfgs(arch)
    jb, pb = BUILDERS[arch]
    solver = dict(batch_size=BATCH, lr=lr, weight_decay=0.01)
    j, p = jb(smoke=True, solver=japi.Solver(**solver)), \
        pb(smoke=True, solver=api.Solver(**solver))
    j.compile()
    p.compile(device="cpu")
    # the graph API lowers to the default bf16; train the f32 tier
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
def test_fit_matches_jax(arch):
    j, p = _graphs(arch)
    data = JSynthetic(j.cfg, BATCH, seed=4).batch
    jl = [h["loss"] for h in j.fit(data, steps=5)]
    pl = [h["loss"] for h in p.fit(data, steps=5)]
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=TOL)
    with j.mesh:
        want = _flat(jexport(j.model, j.params))
    got = convert.state_to_flat(export_logical_params(p.model, p.params))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL, err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

def _trainers(arch, ckpt_j, ckpt_p):
    jcfg, pcfg = _cfgs(arch)
    mesh = make_test_mesh((1, 1))
    with mesh:
        jm = JModel(jcfg, mesh, global_batch=BATCH)
    pm = RecsysModel(pcfg, device="cpu", global_batch=BATCH)
    data = JSynthetic(jcfg, BATCH, seed=4).batch
    jt = JTrainer(jm, JTrainConfig(learning_rate=1e-2), mesh, data,
                  ckpt_dir=ckpt_j, ckpt_interval=1)
    pt = Trainer(pm, TrainConfig(learning_rate=1e-2), data, ckpt_dir=ckpt_p,
                 ckpt_interval=1)
    return mesh, jt, pt


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_round_trip_between_packages(tmp_path, arch):
    """Each package trains 2 steps and checkpoints (params and optimizer
    state, one row-wise AdaGrad accumulator set per collection); the other
    resumes to step 4, level with the writer's own resume. Then
    ``Model.save`` by the port loads in JAX bit for bit, and back."""
    for writer in ("port", "jax"):
        first = tmp_path / writer / "first"
        mesh, jt, pt = _trainers(arch, str(first), str(first))
        if writer == "port":
            pt.train(2)
        else:
            with mesh:
                jt.train(2)
        for d in ("j", "p"):
            shutil.copytree(first, tmp_path / writer / d)
        mesh, jt, pt = _trainers(arch, str(tmp_path / writer / "j"),
                                 str(tmp_path / writer / "p"))
        with mesh:
            jh = jt.train(4)["history"]
        ph = pt.train(4)["history"]
        assert [h["step"] for h in jh] == [h["step"] for h in ph] == [2, 3]
        np.testing.assert_allclose([h["loss"] for h in ph],
                                   [h["loss"] for h in jh], rtol=TOL,
                                   atol=TOL)

    _, pb = BUILDERS[arch]
    p = pb(smoke=True, solver=api.Solver(batch_size=BATCH, lr=1e-2))
    p.compile(device="cpu")
    p.fit(steps=1)
    p.save(str(tmp_path / "saved"))
    want = convert.state_to_flat(export_logical_params(p.model, p.params))
    assert {k.split("/")[0] for k in want if "embedding" in k} == \
        set(p.model.collections())
    j = japi.Model.load(str(tmp_path / "saved"))
    with j.mesh:
        got = _flat(jexport(j.model, j.params))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    j.save(str(tmp_path / "again"))
    q = api.Model.load(str(tmp_path / "again"), device="cpu")
    again = convert.state_to_flat(export_logical_params(q.model, q.params))
    for k, v in want.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


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
                        for t in cfg.all_tables], axis=1).astype(np.int32)
        out.append((dense, cat))
    return out


def _hps_pairs(port, jserver):
    """``(port HPS, JAX HPS, cat columns)`` for every table set."""
    cols = port.model.group_columns()
    out = [(port.hps, jserver.hps, cols["embedding"])]
    if port.wide_hps is not None:
        out.append((port.wide_hps, jserver.wide_hps, cols["embedding"]))
    for name, h in port.extra_hps.items():
        out.append((h, jserver.extra_hps[name], cols[f"embedding@{name}"]))
    return out


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """``arch -> (ps.json, JAX model, requests, {payload: (JAX server,
    its predictions)})``, each JAX bundle deployed once from a JAX
    init."""
    cache = {}

    def get(arch, payload_dtype):
        if arch not in cache:
            d = str(tmp_path_factory.mktemp(arch))
            m = BUILDERS[arch][0](smoke=True)
            m.compile()
            with m.mesh:
                m._params = m.model.init(jax.random.PRNGKey(0))
            m.deploy(d, cache_capacity=64)
            cache[arch] = (os.path.join(d, "ps.json"), m,
                           _requests(m.cfg, 3, 48, seed=11), {})
        ps, m, reqs, servers = cache[arch]
        if payload_dtype not in servers:
            jserver, _ = jbuild(ps, payload_dtype=payload_dtype)
            servers[payload_dtype] = (
                jserver, [jserver.predict(d, c) for d, c in reqs])
        return (ps, m, *servers[payload_dtype], reqs)

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_port_serves_jax_bundle(jax_served, arch, payload_dtype):
    ps, jm, jserver, want, reqs = jax_served(arch, payload_dtype)
    built, graph = build_server_from_config(ps, device="cpu",
                                            payload_dtype=payload_dtype)
    assert graph.name == jm.name
    assert (built.wide_hps is not None) == (arch == "wide-generic")
    assert set(built.extra_hps) == {g.name for g in jm.cfg.extra_groups}
    for (d, c), w in zip(reqs, want):
        np.testing.assert_allclose(built.predict(d, c), w, rtol=PROB_TOL,
                                   atol=PROB_TOL)
    server = InferenceServer(built.model, built.dense_params, built.hps,
                             wide_hps=built.wide_hps,
                             extra_hps=built.extra_hps)
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
        for ph, jh, (lo, hi) in _hps_pairs(built, jserver):
            np.testing.assert_array_equal(ph.lookup(c[:, lo:hi]).numpy(),
                                          np.asarray(jh.lookup(c[:, lo:hi])))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_serves_port_bundle(tmp_path, arch):
    m = BUILDERS[arch][1](smoke=True,
                          solver=api.Solver(batch_size=BATCH, lr=1e-2))
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
    assert set(jserver.extra_hps) == set(server.extra_hps)
    for (d, c), pp in zip(reqs, port_preds):
        want = m.predict({"dense": d, "cat": c})
        got = jserver.predict(d, c)
        assert np.isfinite(got).all() and got.shape == (40,)
        np.testing.assert_allclose(got, want, rtol=PROB_TOL, atol=PROB_TOL)
        np.testing.assert_allclose(pp, want, rtol=PROB_TOL, atol=PROB_TOL)


# ---------------------------------------------------------------------------
# the portable export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_export_is_interchangeable_with_the_reference(tmp_path, arch):
    mesh, jm, jparams, pm, pparams = _pair(arch)
    batch = JSynthetic(jm.cfg, 32, seed=5).batch(1)
    with torch.no_grad():
        want = torch.sigmoid(pm.apply(pparams, put_batch(batch, "cpu"))) \
            .numpy()
    export.export_recsys(pm, pparams, str(tmp_path / "port"),
                         model_name=arch)
    with mesh:
        jexp.export_recsys(jm, jparams, str(tmp_path / "jax"),
                           model_name=arch)
    pg, pw = export.load_exported(str(tmp_path / "port"))
    jg, jw = jexp.load_exported(str(tmp_path / "jax"))
    assert pg["format"] == jg["format"] == "repro-portable-v1"
    assert pg["config_hash"] == jg["config_hash"]
    assert set(pw) == set(jw)
    assert {n["op"] for n in pg["nodes"]} <= jexp.OPSET
    for name, g, w, run in (
            ("port artifact, port executor", pg, pw, export.run_exported),
            ("port artifact, reference executor", pg, pw, jexp.run_exported),
            ("reference artifact, port executor", jg, jw,
             export.run_exported)):
        got = run(g, w, batch)
        assert got.shape == want.shape == (32,), name
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=name)
