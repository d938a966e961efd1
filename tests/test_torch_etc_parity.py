"""ETC-staged training in the port: ``Solver(etc=...)`` against the port's
in-memory ``fit()``, and against the JAX package's ETC fit.

The reference's bar (``tests/test_etc_parity.py``) held in the port: a
cache that covers every vocab row trains like the in-memory path (loss
within 1e-6, ``predict`` within 1e-6 at one id a table; 5e-3 / 2e-2
multi-hot); an evicting cache stays a working approximation; pass
boundaries change nothing (1 and 4 passes equal bit for bit); runs are
deterministic; the cached PS is the durable tier; ``Solver.etc``
validates and round-trips through ``graph.json`` both ways; wide models,
extra groups, ``ckpt_dir`` and ``failure_injector`` are refused.

Across packages: from one JAX-exported state, an evicting f32 ETC fit in
each package gives losses, exported tables and PS rows within 1e-5, and
the same evictions, pulls and touched keysets.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import warnings

import numpy as np

from repro_torch import convert
from repro_torch.api import (CreateSolver, DataReaderParams, DenseLayer,
                             Input, Model, SparseEmbedding)
from repro_torch.configs.base import ETCParams
from repro_torch.models.recsys.dense_graph import GraphError
from repro_torch.models.recsys.model import (RecsysModel,
                                             export_logical_params,
                                             import_logical_params)


def _declare(api, etc=None, seed=0, vocab=(100, 80), hotness=1, lr=1e-2):
    solver = api.CreateSolver(batch_size=64, lr=lr, seed=seed, etc=etc)
    reader = api.DataReaderParams(source="synthetic", num_dense_features=4)
    m = api.Model(solver, reader, name="etc-parity")
    m.add(api.Input(dense_dim=4))
    m.add(api.SparseEmbedding(vocab_sizes=list(vocab), dim=8,
                              top_name="emb", hotness=hotness))
    m.add(api.DenseLayer("mlp", ["dense", "emb"], ["logit"], units=(16, 1)))
    m.add(api.DenseLayer("sigmoid", ["logit"], ["prob"]))
    return m


def _build(etc=None, seed=0, vocab=(100, 80), hotness=1):
    import repro_torch.api as api
    return _declare(api, etc, seed, vocab, hotness).compile(device="cpu")


def _fit(m, steps=20):
    with warnings.catch_warnings():     # full-coverage caches warn
        warnings.simplefilter("ignore", RuntimeWarning)
        return m.fit(steps=steps)


def test_full_coverage_matches_in_memory_oracle():
    """cache_rows >= vocab: every row stays resident, the ETC step is the
    in-memory step."""
    oracle = _build()
    h1 = _fit(oracle)
    etc = _build(etc=ETCParams(cache_rows=100, passes=2))
    h2 = _fit(etc)
    assert abs(h1[-1]["loss"] - h2[-1]["loss"]) < 1e-6
    batch = oracle._reader_data_fn()(999)
    np.testing.assert_allclose(etc.predict(batch), oracle.predict(batch),
                               atol=1e-6)


def test_full_coverage_multi_hot_within_tolerance():
    oracle = _build(hotness=2)
    h1 = _fit(oracle)
    etc = _build(etc=ETCParams(cache_rows=100, passes=2), hotness=2)
    h2 = _fit(etc)
    assert abs(h1[-1]["loss"] - h2[-1]["loss"]) < 5e-3
    batch = oracle._reader_data_fn()(999)
    np.testing.assert_allclose(etc.predict(batch), oracle.predict(batch),
                               atol=2e-2)


def test_evicting_cache_still_learns_and_stays_bounded():
    oracle = _build(vocab=(200, 160), hotness=2)
    _fit(oracle, steps=30)
    m = _build(etc=ETCParams(cache_rows=96, passes=3), vocab=(200, 160),
               hotness=2)
    h2 = _fit(m, steps=30)
    assert m._online.etc.evictions > 0        # capacity actually binds
    assert h2[-1]["loss"] < h2[0]["loss"]     # learning through churn
    batch = oracle._reader_data_fn()(999)
    diff = np.abs(m.predict(batch) - oracle.predict(batch)).max()
    assert diff < 0.15                        # approximation, not drift


def test_pass_boundaries_change_nothing():
    """1 pass vs 4 passes over the same steps: flush + keyset restage at
    each boundary round-trips params and AdaGrad state exactly."""
    a = _build(etc=ETCParams(cache_rows=64, passes=1))
    ha = _fit(a, steps=24)
    b = _build(etc=ETCParams(cache_rows=64, passes=4))
    hb = _fit(b, steps=24)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    batch = a._reader_data_fn()(500)
    np.testing.assert_array_equal(a.predict(batch), b.predict(batch))


def test_etc_run_is_deterministic():
    a = _build(etc=ETCParams(cache_rows=72, passes=2))
    b = _build(etc=ETCParams(cache_rows=72, passes=2))
    ha, hb = _fit(a, steps=16), _fit(b, steps=16)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    batch = a._reader_data_fn()(123)
    np.testing.assert_array_equal(a.predict(batch), b.predict(batch))


def test_reader_replays_purely():
    """The keyset staging replays the reader by step: ``batch(step)``
    must be a pure function of the step, in any order."""
    m = _build()
    data = m._reader_data_fn()
    first = [data(s) for s in (3, 0, 7)]
    again = [data(s) for s in (7, 3, 0)]
    for a, b in zip(first, [again[1], again[2], again[0]]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_cached_ps_resume_continues_training(tmp_path):
    """ps='cached': the flushed memmaps are the durable tier; reopened,
    they hold what the live PS holds."""
    from repro_torch.core.etc.parameter_server import CachedPS
    etc = ETCParams(cache_rows=64, ps="cached",
                    ps_root=str(tmp_path / "ps"), passes=1)
    a = _build(etc=etc)
    _fit(a, steps=10)
    probe = a._reader_data_fn()(42)
    pa = a.predict(probe)
    ps = CachedPS(a.cfg.tables, etc.ps_root)
    rows = ps.pull("f0", np.arange(100))
    got = a._online.ps.pull("f0", np.arange(100))
    np.testing.assert_array_equal(rows, got)     # disk == live PS
    assert pa.shape == probe["label"].shape
    # a trainer over that root, given the trained params, seeds the PS
    # from them and exports them back unchanged
    from repro_torch.online.trainer import OnlineTrainer
    b = _build(etc=etc)
    b._params = a.params
    ot = OnlineTrainer(b, etc, ps=ps)
    np.testing.assert_array_equal(ot.export_params()["embedding"]["dp"],
                                  a.params["embedding"]["dp"])


def test_solver_etc_validation_and_json_roundtrip(tmp_path):
    import repro.api as japi
    from repro.configs.base import ETCParams as JETCParams
    with pytest.raises(GraphError, match="Solver.etc"):
        CreateSolver(etc={"cache_rows": -1})
    with pytest.raises(GraphError, match="Solver.etc"):
        CreateSolver(etc=7)
    with pytest.raises(ValueError, match="ps_root"):
        ETCParams(ps="cached")
    with pytest.raises(ValueError, match="ps"):
        ETCParams(ps="bogus")
    m = _build(etc=ETCParams(cache_rows=77, passes=3))
    path = str(tmp_path / "graph.json")
    m.graph_to_json(path)
    m2 = Model.from_json(path)
    assert isinstance(m2.solver.etc, ETCParams)
    assert (m2.solver.etc.cache_rows, m2.solver.etc.passes) == (77, 3)
    # both ways with the reference
    j = japi.Model.from_json(path)
    assert j.solver.etc == JETCParams(cache_rows=77, passes=3)
    jm = _declare(japi, etc=JETCParams(cache_rows=33, ps="cached",
                                       ps_root="/x", ps_shards=2, passes=5))
    jpath = str(tmp_path / "jgraph.json")
    jm.graph_to_json(jpath)
    p = Model.from_json(jpath)
    assert p.solver.etc == ETCParams(cache_rows=33, ps="cached",
                                     ps_root="/x", ps_shards=2, passes=5)
    assert p.graph_dict() == jm.graph_dict()


def _wide_or_grouped(kind, **solver):
    m = Model(CreateSolver(batch_size=32, etc=ETCParams(cache_rows=32),
                           **solver),
              DataReaderParams(source="synthetic", num_dense_features=4),
              name=f"etc-{kind}")
    m.add(Input(dense_dim=4))
    m.add(SparseEmbedding(vocab_sizes=[50, 40], dim=8, top_name="emb",
                          hotness=2))
    if kind == "wide":
        m.add(SparseEmbedding(vocab_sizes=[50, 40], dim=1, top_name="wide",
                              hotness=2))
        m.add(DenseLayer("mlp", ["dense", "emb"], ["deep_logit"],
                         units=(8, 1)))
        m.add(DenseLayer("reduce_sum", ["wide"], ["wide_logit"]))
        m.add(DenseLayer("sigmoid", ["deep_logit", "wide_logit"], ["prob"]))
    elif kind == "extra":
        m.add(SparseEmbedding(vocab_sizes=[30], dim=4, top_name="ctx"))
        m.add(DenseLayer("mlp", ["dense", "emb", "ctx"], ["logit"],
                         units=(8, 1)))
        m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    else:
        m.add(DenseLayer("mlp", ["dense", "emb"], ["logit"], units=(8, 1)))
        m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    return m.compile(device="cpu")


@pytest.mark.parametrize("kind", ["wide", "extra"])
def test_etc_rejects_wide_and_grouped_models(kind):
    with pytest.raises(GraphError, match="single-collection"):
        _wide_or_grouped(kind).fit(steps=2)


@pytest.mark.parametrize("arg,match", [
    ("ckpt_dir", "ckpt_dir"), ("failure_injector", "failure_injector")])
def test_etc_rejects_ckpt_dir_and_failure_injector(arg, match, tmp_path):
    m = _wide_or_grouped("plain")
    kw = {"ckpt_dir": str(tmp_path)} if arg == "ckpt_dir" else \
        {"failure_injector": lambda step: None}
    with pytest.raises(GraphError, match=match):
        m.fit(steps=2, **kw)


# ---------------------------------------------------------------------------
# across packages: an evicting f32 ETC fit from one JAX-exported state
# ---------------------------------------------------------------------------

def test_evicting_fit_matches_jax():
    import jax
    import repro.api as japi
    from repro.configs.base import ETCParams as JETCParams
    from repro.models.recsys.model import RecsysModel as JModel
    from repro.models.recsys.model import export_logical_params as jexport
    from repro.train.checkpoint import flatten_tree as jflatten

    kw = dict(vocab=(200, 160), hotness=2, lr=5e-2)
    j = _declare(japi, etc=JETCParams(cache_rows=80, passes=2), **kw)
    j.compile()
    p = _build(etc=ETCParams(cache_rows=80, passes=2),
               vocab=kw["vocab"], hotness=kw["hotness"])
    p.solver.lr = j.solver.lr = kw["lr"]
    p._tcfg, j._tcfg = p.solver.to_train_config(), j.solver.to_train_config()
    # the f32 tier: both models at dtype f32, on one JAX init
    j.cfg = dataclasses.replace(j.cfg, dtype="f32")
    with j.mesh:
        j._model = JModel(j.cfg, j.mesh, global_batch=64)
        j._params = j._model.init(jax.random.PRNGKey(3))
    p.cfg = dataclasses.replace(p.cfg, dtype="f32")
    p._model = RecsysModel(p.cfg, device="cpu", global_batch=64)
    p._params = import_logical_params(p.model, convert.state_from_flat(
        jflatten(jexport(j.model, j._params)), device="cpu"))
    data = j._reader_data_fn()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jl = [h["loss"] for h in j.fit(data, steps=8)]
        pl = [h["loss"] for h in p.fit(data, steps=8)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    jo, po = j._online, p._online
    assert po.etc.evictions == jo.etc.evictions > 0
    assert po.etc.pulls == jo.etc.pulls
    for ti, t in enumerate(p.cfg.tables):
        np.testing.assert_array_equal(po.etc.drain_touched(ti),
                                      jo.etc.drain_touched(ti))
        ids = np.arange(t.vocab_size)
        np.testing.assert_allclose(po.ps.pull(t.name, ids),
                                   jo.ps.pull(t.name, ids),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(po.ps.pull_state(t.name, ids),
                                   jo.ps.pull_state(t.name, ids),
                                   rtol=1e-5, atol=1e-5)
    with j.mesh:
        want = {k: np.asarray(v) for k, v in
                jflatten(jexport(j.model, j.params)).items()}
    got = convert.state_to_flat(export_logical_params(p.model, p.params))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
