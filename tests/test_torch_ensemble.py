"""Ensemble bundles and ``MultiModelServer``, the port against the JAX
package on the CPU, at smoke size (DLRM, DCN and NeuMF: 6 tables of up to
1000 rows at D 16; NeuMF in three groups).

- ``ps.json`` (``repro-ps-ensemble-v1``): the port's ``deploy_ensemble``
  writes the reference's file key for key; either package's loader reads
  the other's.
- Bundles both ways: a JAX-written ensemble served by the port and a
  port-written one served by the JAX package. Every member's f32 L1 reads
  are bit-exact across the packages; members rebuilt on an f32 config
  agree within 1e-5 (the f32 sum-order tier), and the served bf16
  probabilities within 2e-2 (the bound ``examples/quickstart.py`` holds
  the JAX server to).
- The port's forms of the reference's ensemble tests
  (``tests/test_serve.py``): the rebuilt server and per-model servers
  equal the in-process ensemble bit for bit, the shared VolatileDB is
  scoped by model, one member's online update never changes another's
  rows at L1, L2 or L3, duplicate names are refused, L1 sized from table
  hotness (``hotness_cache_capacities`` equal to the reference's), the
  observed-miss rebalance (the same capacities as the JAX package after
  the same request stream, predictions unchanged across the resize), the
  rebalancer driven by the serve loop, and ``cache_capacity`` overrides
  on rebuild.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import importlib
import json
import os

import jax
import numpy as np

from repro import api as japi
from repro.configs import dcn_criteo as jdcn
from repro.configs import dlrm_criteo as jdlrm
from repro.configs import neumf_criteo as jneumf
from repro.configs.base import ensemble_config_from_dict as j_ens_from_dict
from repro.configs.base import ensemble_config_to_dict as j_ens_to_dict
from repro.data.synthetic import SyntheticCTR
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_server_from_config as jbuild
from repro.models.recsys.model import RecsysModel as JModel
from repro.serve.server import InferenceServer as JServer
from repro_torch import api
from repro_torch.configs import registry
from repro_torch.configs.base import (
    EnsembleConfig, HPSConfig, ensemble_config_to_dict, ps_config_from_dict)
from repro_torch.core.hps.message_bus import MessageBus, Producer
from repro_torch.launch.serve import build_server_from_config
from repro_torch.models.recsys import layers
from repro_torch.models.recsys.model import RecsysModel
from repro_torch.serve.server import InferenceServer, MultiModelServer

ARCHS = ("dlrm-criteo", "dcn-criteo", "neumf-criteo")
JRECIPES = {"dlrm-criteo": jdlrm, "dcn-criteo": jdcn,
            "neumf-criteo": jneumf}
#: f32 members of the two packages (the sum-order tier); served bf16
#: probabilities (the DLRM bound)
F32_TOL = 1e-5
PROB_TOL = 2e-2


@pytest.fixture(autouse=True)
def _no_tf32():
    layers.pin_f32_matmul()


def _port_model(arch, *, fit_steps=0, seed=0):
    solver = api.Solver(batch_size=16, lr=1e-2)
    if arch in registry.RECSYS_RECIPES:
        m = importlib.import_module(registry.RECSYS_RECIPES[arch]) \
            .build_model(smoke=True, solver=solver)
    else:
        m = api.recipe_graph(
            registry.reduce_recsys_for_smoke(registry.RECSYS_ARCHS[arch]),
            solver=solver)
    m.compile(device="cpu")
    if fit_steps:
        m.fit(steps=fit_steps)
    else:
        m._params = m.model.init(torch.Generator().manual_seed(seed))
    return m


def _jax_model(arch, seed=0):
    m = JRECIPES[arch].build_model(smoke=True)
    m.compile()
    with m.mesh:
        m._params = m.model.init(jax.random.PRNGKey(seed))
    return m


def _batches(cfgs, rows=8, seed=3):
    return {name: SyntheticCTR(cfg, rows, seed=seed).batch(7)
            for name, cfg in cfgs.items()}


@pytest.fixture(scope="module")
def port_ens(tmp_path_factory):
    """DLRM, DCN and NeuMF trained briefly on the port and deployed as ONE
    ensemble bundle over a shared VDB / PDB / bus. DLRM's and DCN's smoke
    tables are both named C1..C6, so a missing model scope at any storage
    level shows up as cross-model corruption."""
    models = [_port_model(a, fit_steps=2) for a in ARCHS]
    d = str(tmp_path_factory.mktemp("port_ens"))
    bus = MessageBus()
    server = api.deploy_ensemble(models, d, cache_capacity=128, bus=bus)
    return models, d, bus, server


@pytest.fixture(scope="module")
def jax_ens(tmp_path_factory):
    """The same three recipes on the JAX package, one init each, deployed
    as one ensemble bundle with the reference's default sizing."""
    models = [_jax_model(a) for a in ARCHS]
    d = str(tmp_path_factory.mktemp("jax_ens"))
    server = japi.deploy_ensemble(models, d, cache_budget=3 * 96)
    return models, d, server


# ---------------------------------------------------------------------------
# ps.json
# ---------------------------------------------------------------------------

def test_ps_json_dispatch_and_round_trip(port_ens, jax_ens):
    for d in (port_ens[1], jax_ens[1]):
        with open(os.path.join(d, "ps.json")) as f:
            doc = json.load(f)
        cfg = ps_config_from_dict(doc)
        assert isinstance(cfg, EnsembleConfig)
        assert all(isinstance(m, HPSConfig) for m in cfg.models)
        assert json.loads(json.dumps(ensemble_config_to_dict(cfg))) == doc
        assert json.loads(json.dumps(j_ens_to_dict(
            j_ens_from_dict(doc)))) == doc
    one = cfg.models[0]
    with pytest.raises(ValueError, match="duplicate"):
        EnsembleConfig(models=(one, one))
    with pytest.raises(ValueError, match="pdb_root"):
        EnsembleConfig(models=(one, dataclasses.replace(
            cfg.models[1], pdb_root="elsewhere")))


def test_ps_json_equals_jax_key_for_key(jax_ens, tmp_path):
    """The same three recipes deployed by each package with the same
    budget: the same members, paths, hotness-sized capacities and config
    hashes."""
    models = [_port_model(a) for a in ARCHS]
    server = api.deploy_ensemble(models, str(tmp_path), cache_budget=3 * 96)
    server.close()
    with open(tmp_path / "ps.json") as f:
        ours = json.load(f)
    with open(os.path.join(jax_ens[1], "ps.json")) as f:
        ref = json.load(f)
    assert ours == ref
    for e in ours["models"]:
        for k in ("graph_path", "dense_weights_path"):
            assert os.path.exists(tmp_path / e[k])


# ---------------------------------------------------------------------------
# bundles, both ways
# ---------------------------------------------------------------------------

def _f32_port(member):
    cfg = dataclasses.replace(member.model.cfg, dtype="f32")
    return InferenceServer(RecsysModel(cfg, device="cpu"),
                           member.dense_params, member.hps,
                           wide_hps=member.wide_hps,
                           extra_hps=member.extra_hps)


def _f32_jax(member):
    cfg = dataclasses.replace(member.model.cfg, dtype="f32")
    mesh = make_test_mesh((1, 1))
    with mesh:
        model = JModel(cfg, mesh, global_batch=16)
    return JServer(model, member.dense_params, member.hps,
                   wide_hps=member.wide_hps,
                   extra_hps=member.extra_hps or None)


def _hpses(member):
    out = [member.hps] + ([member.wide_hps] if member.wide_hps else [])
    return out + list(member.extra_hps.values())


def _same_across_packages(port, jax_server, cfgs):
    """Every member of the port's MultiModelServer against the JAX one:
    f32 L1 reads bit-exact, f32 members within 1e-5, served bf16 within
    2e-2."""
    assert sorted(port.models) == sorted(jax_server.models)
    batches = _batches(cfgs)
    for name, b in batches.items():
        pm, jm = port[name], jax_server[name]
        np.testing.assert_allclose(
            port.predict(name, b["dense"], b["cat"]),
            jax_server.predict(name, b["dense"], b["cat"]),
            rtol=PROB_TOL, atol=PROB_TOL, err_msg=name)
        got = _f32_port(pm).predict(b["dense"], b["cat"])
        want = _f32_jax(jm).predict(b["dense"], b["cat"])
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
        cols = dict(pm.model.group_columns())
        keys = ["embedding"] + (["embedding"] if pm.wide_hps else []) + \
            [f"embedding@{g}" for g in pm.extra_hps]
        for key, ph, jh in zip(keys, _hpses(pm), _hpses(jm)):
            lo, hi = cols[key] if pm.extra_hps else (0, b["cat"].shape[1])
            c = b["cat"][:, lo:hi, :]
            np.testing.assert_array_equal(ph.lookup(c).numpy(),
                                          np.asarray(jh.lookup(c)),
                                          err_msg=f"{name} {key}")


def test_port_serves_jax_ensemble(jax_ens):
    models, d, jserver = jax_ens
    built, graphs = build_server_from_config(os.path.join(d, "ps.json"),
                                             device="cpu")
    assert isinstance(built, MultiModelServer)
    assert sorted(graphs) == sorted(m.name for m in models)
    caps = {m.name: jserver[m.name].hps.cache_capacity for m in models}
    assert {n: s.hps.cache_capacity for n, s in built.servers.items()} \
        == caps
    _same_across_packages(built, jserver, {m.name: m.cfg for m in models})
    built.close()


def test_jax_serves_port_ensemble(port_ens):
    models, d, _, server = port_ens
    jserver, jgraphs = jbuild(os.path.join(d, "ps.json"))
    assert sorted(jgraphs) == sorted(m.name for m in models)
    _same_across_packages(server, jserver, {m.name: m.cfg for m in models})


# ---------------------------------------------------------------------------
# the reference's ensemble tests, on the port
# ---------------------------------------------------------------------------

def test_ensemble_bundle_roundtrip(port_ens):
    models, d, _, server = port_ens
    batches = _batches({m.name: m.cfg for m in models})
    rebuilt, loaded = build_server_from_config(os.path.join(d, "ps.json"),
                                               device="cpu")
    assert sorted(rebuilt.models) == sorted(m.name for m in models)
    for m in models:
        b = batches[m.name]
        np.testing.assert_array_equal(
            rebuilt.predict(m.name, b["dense"], b["cat"]),
            server.predict(m.name, b["dense"], b["cat"]))
        assert loaded[m.name].to_recsys_config() == m.cfg
    rebuilt.close()


def test_ensemble_matches_independent_servers(port_ens, tmp_path):
    models, d, _, server = port_ens
    batches = _batches({m.name: m.cfg for m in models})
    for m in models:
        solo = m.deploy(str(tmp_path / m.name), cache_capacity=128)
        b = batches[m.name]
        np.testing.assert_array_equal(
            server.predict(m.name, b["dense"], b["cat"]),
            solo.predict(b["dense"], b["cat"]))
        solo.close()


def test_ensemble_shared_vdb_is_model_scoped(port_ens):
    models, d, _, server = port_ens
    for name, b in _batches({m.name: m.cfg for m in models}).items():
        server.predict(name, b["dense"], b["cat"])
    for m in models:
        assert server.vdb.size(f"{m.name}/C1") > 0
    assert server.vdb.size("C1") == 0


def test_ensemble_online_update_isolation(port_ens):
    """An online update on ONE model's topics reaches that model's
    serving path and leaves every other member's rows, at L1, L2 and
    L3, as they were."""
    models, d, bus, server = port_ens
    a = models[0]
    batches = _batches({m.name: m.cfg for m in models})
    ba = batches[a.name]
    ids = np.unique(ba["cat"][:, 0, 0])
    ids = ids[ids >= 0][:4]
    before = {n: server.predict(n, b["dense"], b["cat"])
              for n, b in batches.items()}
    others = [m for m in models if m.name != a.name]
    l1 = {m.name: [h.lookup(batches[m.name]["cat"][:, :len(h.tables)])
                   .numpy() for h in [server[m.name].hps]]
          for m in others}
    l2 = {m.name: server.vdb.query(f"{m.name}/C1", ids) for m in others}
    l3 = {m.name: server.pdb.fetch(m.name, "C1", ids) for m in others}

    prod = Producer(bus, a.name)
    prod.send("C1", ids, np.full((len(ids), a.cfg.tables[0].dim), 77.5,
                                 np.float32))
    prod.flush()
    sa = server[a.name]
    assert sa.hps.apply_updates() == 1
    for m in others:
        assert server[m.name].hps.apply_updates() == 0   # not its topic
    while sa.hps.refresh_backlog():
        sa.hps.refresh_step(budget=64)

    after_a = server.predict(a.name, ba["dense"], ba["cat"])
    assert not np.array_equal(before[a.name], after_a)
    for m in others:
        b = batches[m.name]
        np.testing.assert_array_equal(
            server.predict(m.name, b["dense"], b["cat"]), before[m.name])
        h = server[m.name].hps
        np.testing.assert_array_equal(
            h.lookup(b["cat"][:, :len(h.tables)]).numpy(), l1[m.name][0])
        mask, rows = server.vdb.query(f"{m.name}/C1", ids)
        np.testing.assert_array_equal(mask, l2[m.name][0])
        if rows is not None:
            np.testing.assert_array_equal(rows[mask], l2[m.name][1][mask])
        np.testing.assert_array_equal(server.pdb.fetch(m.name, "C1", ids),
                                      l3[m.name])


def test_ensemble_rejects_duplicate_names(port_ens, tmp_path):
    models = port_ens[0]
    with pytest.raises(api.GraphError, match="unique"):
        api.deploy_ensemble([models[0], models[0]], str(tmp_path / "dup"))
    with pytest.raises(api.GraphError, match="unknown models"):
        api.deploy_ensemble(models[:1], str(tmp_path / "unk"),
                            cache_capacity={"nope": 8})


def _tiny_graph(pkg, name, hotness, vocab=400):
    """A minimal trainable graph whose table hotness the test sets, in
    either package's graph API."""
    m = pkg.Model(pkg.Solver(batch_size=8, lr=1e-2),
                  pkg.DataReaderParams(num_dense_features=4), name=name)
    m.add(pkg.Input(dense_dim=4))
    m.add(pkg.SparseEmbedding(vocab_sizes=[vocab, vocab], dim=8,
                              hotness=hotness, top_name="emb"))
    m.add(pkg.DenseLayer("concat", ["dense", "emb"], ["flat"]))
    m.add(pkg.DenseLayer("mlp", ["flat"], ["deep"], units=(8,)))
    m.add(pkg.DenseLayer("concat", ["flat", "deep"], ["both"]))
    m.add(pkg.DenseLayer("mlp", ["both"], ["logit"], units=(1,)))
    if pkg is api:
        m.compile(device="cpu")
    else:
        m.compile()
    m.fit(steps=1)
    return m


def test_hotness_capacities_match_jax(tmp_path):
    pairs = [(_tiny_graph(api, "hot-model", 8),
              _tiny_graph(japi, "hot-model", 8)),
             (_tiny_graph(api, "cold-model", 1),
              _tiny_graph(japi, "cold-model", 1))]
    recipes = [(_port_model(a), _jax_model(a)) for a in ARCHS]
    for members in (pairs, recipes, pairs + recipes):
        for budget in (64, 2048, 131072):
            ours = api.hotness_cache_capacities([p for p, _ in members],
                                                budget)
            ref = japi.hotness_cache_capacities([j for _, j in members],
                                                budget)
            assert ours == ref, (budget, ours, ref)
    for p, j in pairs + recipes:
        assert api._hotness_demand(p.cfg.all_tables) == \
            japi._hotness_demand(j.cfg.all_tables)

    hot, cold = (p for p, _ in pairs)
    want = api.hotness_cache_capacities([hot, cold], budget=2048)
    assert want["hot-model"] > want["cold-model"]
    for sub, kw, expect in (
            ("auto", dict(cache_budget=2048), want),
            ("uniform", dict(cache_capacity=96),
             {"hot-model": 96, "cold-model": 96}),
            ("pin", dict(cache_budget=2048,
                         cache_capacity={"cold-model": 77}),
             {**want, "cold-model": 77})):
        api.deploy_ensemble([hot, cold], str(tmp_path / sub), **kw).close()
        with open(tmp_path / sub / "ps.json") as f:
            caps = {m["model"]: m["cache_capacity"]
                    for m in json.load(f)["models"]}
        assert caps == expect, sub
    assert abs(sum(want.values()) - 2048) <= 2 * 64


def test_rebalance_matches_jax(tmp_path):
    """The same request stream through both packages' ensembles: the
    rebalance gives the same capacities (the hot member grows, the idle
    one drops to the floor, the budget holds), and the resized members
    serve what they served before, bit for bit."""
    caps = {}
    for pkg in (api, japi):
        hot, cold = (_tiny_graph(pkg, n, 4) for n in ("hot-m", "cold-m"))
        server = pkg.deploy_ensemble(
            [hot, cold], str(tmp_path / pkg.__name__), cache_budget=1024,
            rebalance_interval_s=3600.0)
        try:
            batches = {m.name: SyntheticCTR(m.cfg, 8, seed=3).batch(7)
                       for m in (hot, cold)}
            for name, b in batches.items():
                server.predict(name, b["dense"], b["cat"])
            first = server.rebalance_now()
            bc = batches["cold-m"]
            before = server.predict("cold-m", bc["dense"], bc["cat"])
            ds = SyntheticCTR(hot.cfg, 16)
            for step in range(12):
                b = ds.batch(step)
                server.predict("hot-m", b["dense"], b["cat"])
            got = server.rebalance_now()
            assert got["hot-m"] > got["cold-m"] >= 64
            assert sum(got.values()) <= 1024 + 2 * 64
            st = server.rebalance_stats()
            assert st["rebalances"] >= 1 and st["capacities"] == got
            np.testing.assert_array_equal(
                server.predict("cold-m", bc["dense"], bc["cat"]), before)
            caps[pkg.__name__] = (first, got)
        finally:
            server.stop()
    assert caps["repro_torch.api"] == caps["repro.api"]


def test_rebalance_runs_from_the_serve_loop(tmp_path):
    """``rebalance_interval_s`` registers the rebalancer as every member's
    ``on_tick``: traffic to one member through ``submit`` re-splits the
    budget with no call from the caller (at interval 0 every tick splits
    anew, so the final split depends on the last tick's misses)."""
    hot, cold = (_tiny_graph(api, n, 4) for n in ("hot-m", "cold-m"))
    server = api.deploy_ensemble([hot, cold], str(tmp_path),
                                 cache_budget=1024, rebalance_interval_s=0.0)
    assert all(s.on_tick == server._rebalance_tick
               for s in server.servers.values())
    server.start()
    try:
        ds = SyntheticCTR(hot.cfg, 16)
        handles = [server.submit("hot-m", b["dense"], b["cat"])
                   for b in (ds.batch(i) for i in range(6))]
        for h in handles:
            assert not isinstance(h.get(timeout=60), BaseException)
    finally:
        server.stop()       # joins the loops: their last tick is done
    st = server.rebalance_stats()
    assert st["rebalances"] >= 1       # the tick after hot-m's misses
    assert sum(st["capacities"].values()) <= 1024 + 2 * 64
    server.close()


def test_rebuild_with_cache_capacity_override(tmp_path):
    a, b = (_tiny_graph(api, n, 2) for n in ("model-a", "model-b"))
    api.deploy_ensemble([a, b], str(tmp_path), cache_capacity=128).close()
    ps = str(tmp_path / "ps.json")
    for override, want in (({"model-a": 32}, (32, 128)), (48, (48, 48))):
        rebuilt, _ = build_server_from_config(ps, device="cpu",
                                              cache_capacity=override)
        got = tuple(next(iter(rebuilt[n].hps.caches.values())).capacity
                    for n in ("model-a", "model-b"))
        assert got == want
        rebuilt.close()
    with pytest.raises(KeyError, match="unknown model"):
        rebuilt["model-c"]
