"""The rest of the serving engine, the port against the JAX package on
the CPU: admission control, the three engines, ragged ``hotness``, the
``on_tick`` hook and the counters, the latency histogram, and the
hot-path sanitizer twin.

- ``deadline_batch_target`` equals the reference's on a grid that covers
  its edges; the port's forms of the 9 tests of
  ``tests/test_slo_serving.py`` (typed, immediate, exactly counted
  shedding on a stopped server; ``close()`` never strands a handle; the
  two serving locks never nest).
- ``stream``, ``sync`` and ``stage_sync`` give the same predictions bit
  for bit (one HPS, a wide model's two, an N-group model's three).
- Ragged ``[B, sum(hotness)]`` requests on a single-group server: the
  f32 L1 reads equal the JAX server's bit for bit and the bf16
  probabilities agree within 2e-2 (the bound ``examples/quickstart.py``
  holds the JAX server to); an N-group server refuses a 2-D ``cat`` in
  both packages.
- ``LatencyHistogram`` / ``WindowedRate``: the same records give the
  reference's ``to_dict``, summary and series exactly.
- The port's forms of the 10 tests of ``tests/test_hotpath_sanitizer.py``:
  the twin armed over CPU tensors (where every ``cpu`` / ``numpy`` /
  ``item`` / ``tolist`` / ``__array__`` call and the port's fence count,
  as on the card), one sync per served group and no fresh kernel-library
  load, with admission on too, and ``stage_sync`` as the positive
  control that syncs more.
"""
import pytest

torch = pytest.importorskip("torch")

import ast
import importlib
import os
import queue
import threading
import time

import jax
import numpy as np

from repro.configs import dlrm_criteo as jdlrm
from repro.configs import neumf_criteo as jneumf
from repro.launch.serve import build_server_from_config as jbuild
from repro.loadgen import metrics as jmetrics
from repro.serve import server as jserver_mod
from repro_torch import api
from repro_torch import device as devmod
from repro_torch.analysis import HotPathMonitor, LockOrderRecorder, active_monitor
from repro_torch.configs import registry
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.kernels import _build
from repro_torch.launch.serve import build_server_from_config
from repro_torch.loadgen import metrics
from repro_torch.serve.server import (
    ENGINES, InferenceServer, MultiModelServer, ServerOverloaded,
    deadline_batch_target)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: served bf16 probabilities of the two packages
PROB_TOL = 2e-2


class _NoModel:
    """Stands in where the dense net is never reached: the admission
    tests never let a request group through to the device."""

    def apply_dense(self, *a, **k):
        raise AssertionError("admission test served a request group")


def _req(rows=1):
    return (np.zeros((rows, 2), np.float32),
            np.zeros((rows, 1, 1), np.int32))


def _fit(m, steps=2):
    m.compile(device="cpu")
    m.fit(steps=steps)
    return m


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A briefly trained smoke DLRM deployed once; each test builds its
    own server over the deployment's HPS."""
    m = _fit(_recipe("dlrm-criteo"))
    server = m.deploy(str(tmp_path_factory.mktemp("tiny")),
                      cache_capacity=64)
    return m, server.hps


def _batch(cfg, rows, seed):
    b = SyntheticCTR(cfg, rows, seed=seed).batch(0)
    return b["dense"], b["cat"]


# ---------------------------------------------------------------------------
# the deadline batch-cut decision
# ---------------------------------------------------------------------------

def test_deadline_target_never_busts_the_budget():
    rng = np.random.default_rng(0)
    for _ in range(1000):
        slo = float(rng.uniform(1.0, 200.0))
        age = float(rng.uniform(0.0, 2.0 * slo))
        max_batch = int(rng.integers(1, 257))
        per_row = None if rng.random() < 0.2 \
            else float(rng.uniform(0.01, 10.0))
        t = deadline_batch_target(age, slo, max_batch, per_row)
        assert 1 <= t <= max_batch
        if t > 1 and per_row is not None:
            assert age + t * per_row <= slo, (age, slo, per_row, t)


def test_deadline_target_edges():
    assert deadline_batch_target(100.0, 50.0, 64, 1.0) == 1
    assert deadline_batch_target(10.0, 50.0, 64, None) == 64
    assert deadline_batch_target(0.0, 1000.0, 64, 1.0) == 64
    assert deadline_batch_target(40.0, 50.0, 64, 5.0) == 2


@pytest.mark.parametrize("per_row", [None, 0.0, -1.0, 1e-3, 0.5, 5.0,
                                     1e3])
def test_deadline_target_matches_jax(per_row):
    """The reference's decision on a grid over its edges: the age at,
    just under and past the SLO, a slack smaller than one row, and
    ``max_batch`` 1."""
    for slo in (1.0, 10.0, 50.0):
        for age in (0.0, slo - 1e-9, slo - 0.5, slo, slo + 1.0, 0.3 * slo):
            for max_batch in (1, 2, 63, 1024):
                args = (age, slo, max_batch, per_row)
                assert deadline_batch_target(*args) == \
                    jserver_mod.deadline_batch_target(*args), args


# ---------------------------------------------------------------------------
# bounded-queue shedding: typed, immediate, exactly counted
# ---------------------------------------------------------------------------

def test_full_queue_sheds_exactly_the_overflow():
    depth, extra = 5, 3
    s = InferenceServer(_NoModel(), {}, None, engine="sync",
                        queue_depth=depth)
    admitted = [s.submit(*_req()) for _ in range(depth)]
    rejected = [s.submit(*_req()) for _ in range(extra)]
    for h in rejected:
        out = h.get_nowait()
        assert isinstance(out, ServerOverloaded)
        assert "queue full" in str(out)
    for h in admitted:
        with pytest.raises(queue.Empty):
            h.get_nowait()
    assert s.counters()["requests_shed"] == extra
    # the reference's server keeps the same counters under the same calls
    j = jserver_mod.InferenceServer(_NoModel(), {}, None, engine="sync",
                                    queue_depth=depth)
    for _ in range(depth + extra):
        j.submit(*_req())
    assert s.counters() == j.counters()


def test_submit_after_close_is_typed_rejection():
    s = InferenceServer(_NoModel(), {}, None, engine="sync",
                        queue_depth=4)
    pending = s.submit(*_req())
    s.close()
    assert isinstance(pending.get_nowait(), ServerOverloaded)
    out = s.submit(*_req()).get_nowait()
    assert isinstance(out, ServerOverloaded)
    assert "closed" in str(out)
    assert s.counters()["requests_shed"] == 2
    with pytest.raises(RuntimeError, match="closed"):
        s.start()


def test_set_admission_requires_stopped_server():
    s = InferenceServer(_NoModel(), {}, None, engine="sync")
    s.start()
    try:
        with pytest.raises(RuntimeError, match="stopped"):
            s.set_admission(queue_depth=2)
    finally:
        s.stop()
    s.set_admission(queue_depth=2, slo_ms=50.0)
    assert s.queue_depth == 2 and s.slo_ms == 50.0


def test_set_admission_shrink_sheds_overflow():
    s = InferenceServer(_NoModel(), {}, None, engine="sync")
    handles = [s.submit(*_req()) for _ in range(5)]
    s.set_admission(queue_depth=2)
    resolved = [h for h in handles
                if not h.empty()
                and isinstance(h.get_nowait(), ServerOverloaded)]
    assert len(resolved) == 3
    assert s.counters()["requests_shed"] == 3
    assert s._q.qsize() == 2


def test_expired_head_is_shed_and_fixed_arm_serves_it():
    """A request older than the SLO at drain time is shed (counted in
    ``requests_expired``) with deadline batching on; the fixed arm
    (``deadline_batching=False``) keeps it. Admission time is set in the
    past, so nothing races the clock; the reference's server, given the
    same requests, ends with the same counters."""
    for deadline, want in ((True, None), (False, 1)):
        counters = []
        for cls in (InferenceServer, jserver_mod.InferenceServer):
            s = cls(_NoModel(), {}, None, engine="sync", slo_ms=5.0,
                    deadline_batching=deadline)
            h = s.submit(*_req())
            req = s._q.get_nowait()
            req = req._replace(t_enq=req.t_enq - 1.0)
            group = s._coalesce(req)
            if want is None:
                assert group is None
                assert type(h.get_nowait()).__name__ == "ServerOverloaded"
            else:
                reqs, dense, _ = group
                assert len(reqs) == want and dense.shape == (1, 2)
                s._deliver(reqs, np.zeros(1, np.float32))
            counters.append(s.counters())
        assert counters[0] == counters[1]
        c = counters[0]
        assert (c["requests_expired"], c["slo_violations"]) == \
            ((1, 0) if want is None else (0, 1))


@pytest.mark.parametrize("age_ms,est", [(0.0, None), (1.0, 0.01),
                                        (3.7, 0.5), (6.0, 0.01)])
def test_batch_target_matches_jax(monkeypatch, age_ms, est):
    """The EWMA of ms a row that ``_record_latency`` keeps, and the
    batcher's cut for a head of a given age, equal the reference's (the
    clock is fixed, so both see the same ages)."""
    now = 100.0
    monkeypatch.setattr(time, "perf_counter", lambda: now)
    outs = []
    for cls in (InferenceServer, jserver_mod.InferenceServer):
        s = cls(_NoModel(), {}, None, max_batch=64, slo_ms=5.0)
        s._service_ms_per_row = est
        s._record_latency(now - 0.002, rows=8)      # 2 ms for 8 rows
        ewma = s._service_ms_per_row
        if est is not None:     # the batcher reads the estimate it is given
            s._service_ms_per_row = est
        req = s.submit(*_req()) and s._q.get_nowait()
        req = req._replace(t_enq=now - age_ms / 1e3)
        outs.append((ewma, s._batch_target(req)))
    assert outs[0] == outs[1]
    assert outs[0][0] == pytest.approx(0.25 if est is None
                                       else 0.8 * est + 0.2 * 0.25)


# ---------------------------------------------------------------------------
# close() under live load; the ensemble's close
# ---------------------------------------------------------------------------

def test_close_never_strands_a_handle_under_load(tiny):
    m, hps = tiny
    s = InferenceServer(m.model, m.dense_params(), hps, max_batch=8)
    s.start()
    handles = []
    try:
        for i in range(30):
            handles.append(s.submit(*_batch(m.cfg, 4, i)))
    finally:
        s.close()   # mid-flight: some groups served, the rest queued
    served = shed = 0
    for h in handles:
        out = h.get(timeout=60)
        if isinstance(out, ServerOverloaded):
            shed += 1
        else:
            assert not isinstance(out, BaseException)
            assert out.shape == (4,) and np.isfinite(out).all()
            served += 1
    assert served + shed == len(handles)
    c = s.counters()
    assert c["requests_delivered"] == served
    assert c["requests_shed"] == shed


def test_closed_multi_model_resolves_every_member(tiny):
    m, hps = tiny
    members = {n: InferenceServer(m.model, m.dense_params(), hps,
                                  max_batch=8, queue_depth=8)
               for n in ("a", "b")}
    mm = MultiModelServer(members)
    handles = [mm.submit(n, *_batch(m.cfg, 2, i))
               for i, n in enumerate(("a", "b", "a"))]
    mm.close()
    for h in handles:
        assert isinstance(h.get(timeout=10), ServerOverloaded)
    st = mm.stats()
    assert st["a"]["requests_shed"] == 2
    assert st["b"]["requests_shed"] == 1


def test_admission_and_stats_locks_acyclic(tiny):
    m, hps = tiny
    s = InferenceServer(m.model, m.dense_params(), hps, max_batch=8,
                        queue_depth=16, slo_ms=10_000.0)
    rec = LockOrderRecorder()
    rec.wrap(s, "_admit_lock", "InferenceServer._admit_lock")
    rec.wrap(s, "_stats_lock", "InferenceServer._stats_lock")
    s.start()
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            s.counters()
            s.latency_percentiles()
            time.sleep(1e-3)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        handles = [s.submit(*_batch(m.cfg, 2, i)) for i in range(40)]
        for h in handles:
            out = h.get(timeout=60)
            assert not isinstance(out, BaseException) \
                or isinstance(out, ServerOverloaded)
    finally:
        stop.set()
        t.join(timeout=60)
        s.stop()
    assert not t.is_alive()
    assert s.counters()["requests_delivered"] > 0
    assert rec.edges() == set()
    rec.assert_acyclic()


# ---------------------------------------------------------------------------
# the three engines, bit for bit
# ---------------------------------------------------------------------------

def _recipe(arch):
    """The smoke model of ``arch`` on the port's graph API."""
    solver = api.Solver(batch_size=16, lr=1e-2)
    if arch in registry.RECSYS_RECIPES:
        return importlib.import_module(registry.RECSYS_RECIPES[arch]) \
            .build_model(smoke=True, solver=solver)
    cfg = registry.reduce_recsys_for_smoke(registry.RECSYS_ARCHS[arch])
    return api.recipe_graph(cfg, solver=solver)


def _serve_all(server, reqs):
    server.start()
    try:
        outs = [h.get(timeout=120) for h in
                [server.submit(d, c) for d, c in reqs]]
    finally:
        server.stop()
    for o in outs:
        assert not isinstance(o, BaseException), o
    return outs


@pytest.mark.parametrize("arch", ["dlrm-criteo", "wdl-criteo",
                                  "neumf-criteo"])
def test_engines_give_the_same_predictions(tmp_path, arch):
    """One deployment, three servers over its HPSes, one per engine, and
    the same requests one at a time (one group each): the predictions
    are equal bit for bit; ``stage_sync`` also through its own method."""
    m = _fit(_recipe(arch), steps=1)
    base = m.deploy(str(tmp_path), cache_capacity=48, max_batch=16)
    reqs = [_batch(m.cfg, 16, 100 + i) for i in range(4)]
    got = {}
    for engine in ENGINES:
        s = InferenceServer(m.model, base.dense_params, base.hps,
                            wide_hps=base.wide_hps,
                            extra_hps=base.extra_hps, max_batch=16,
                            engine=engine)
        got[engine] = [_serve_all(s, [r])[0] for r in reqs]
        assert s.counters()["groups_served"] == len(reqs)
    direct = InferenceServer(m.model, base.dense_params, base.hps,
                             wide_hps=base.wide_hps,
                             extra_hps=base.extra_hps, engine="stage_sync")
    got["direct"] = [direct._predict_stage_sync(d, c) for d, c in reqs]
    for engine, outs in got.items():
        for o, w in zip(outs, got["stream"]):
            assert o.shape == (16,)
            np.testing.assert_array_equal(o, w, err_msg=engine)
    base.close()


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="stage_sync"):
        InferenceServer(_NoModel(), {}, None, engine="async")


# ---------------------------------------------------------------------------
# ragged hotness
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dlrm_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jdlrm"))
    m = jdlrm.build_model(smoke=True)
    m.compile()
    with m.mesh:
        m._params = m.model.init(jax.random.PRNGKey(0))
    m.deploy(d, cache_capacity=64)
    return os.path.join(d, "ps.json"), m


def _ragged(cfg, hotness, b, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-1, t.vocab_size, (b, h))
            for t, h in zip(cfg.tables, hotness)]
    return (rng.standard_normal((b, cfg.num_dense_features))
            .astype(np.float32),
            np.concatenate(cols, axis=1).astype(np.int32))


@pytest.mark.parametrize("engine", ["stream", "sync", "stage_sync"])
def test_ragged_hotness_matches_jax(jax_dlrm_bundle, engine):
    ps, jm = jax_dlrm_bundle
    hot = [1 + i % 3 for i in range(len(jm.cfg.tables))]
    jbase, _ = jbuild(ps)
    jserver = jserver_mod.InferenceServer(
        jm.model, jbase.dense_params, jbase.hps, hotness=hot)
    built, _ = build_server_from_config(ps, device="cpu")
    server = InferenceServer(built.model, built.dense_params, built.hps,
                             hotness=hot, engine=engine)
    reqs = [_ragged(jm.cfg, hot, 12, seed=40 + i) for i in range(3)]
    outs = _serve_all(server, reqs)
    for (d, c), o in zip(reqs, outs):
        want = jserver.predict(d, c)
        assert o.shape == want.shape == (12,)
        np.testing.assert_allclose(o, want, rtol=PROB_TOL, atol=PROB_TOL)
        np.testing.assert_array_equal(
            built.hps.lookup(c, hot).numpy(),
            np.asarray(jbase.hps.lookup(c, hot)))
    server.close()


def test_ngroup_server_refuses_2d_cat_in_both_packages(tmp_path):
    """The reference slices ``cat[:, lo:hi, :]`` per group, so its
    N-group server cannot take a ragged 2-D request; neither can the
    port's, which says why."""
    d = str(tmp_path / "neumf")
    jm = jneumf.build_model(smoke=True)
    jm.compile()
    with jm.mesh:
        jm._params = jm.model.init(jax.random.PRNGKey(0))
    jm.deploy(d, cache_capacity=32)
    jbase, _ = jbuild(os.path.join(d, "ps.json"))
    built, _ = build_server_from_config(os.path.join(d, "ps.json"),
                                        device="cpu")
    cfg = jm.cfg
    n = len(cfg.all_tables)
    hot = [1] * n
    dense = np.zeros((4, cfg.num_dense_features), np.float32)
    cat2d = np.zeros((4, n), np.int32)
    jserver = jserver_mod.InferenceServer(
        jm.model, jbase.dense_params, jbase.hps,
        extra_hps=jbase.extra_hps, hotness=hot)
    with pytest.raises(IndexError):
        jserver.predict(dense, cat2d)
    server = InferenceServer(built.model, built.dense_params, built.hps,
                             extra_hps=built.extra_hps, hotness=hot)
    with pytest.raises(ValueError, match="N-group"):
        server.predict(dense, cat2d)
    # the [B, T, H] form serves in both, with the same L1 reads
    cat3d = cat2d[:, :, None]
    got = server.predict(dense, cat3d)
    np.testing.assert_allclose(got, jserver.predict(dense, cat3d),
                               rtol=PROB_TOL, atol=PROB_TOL)
    server.close()


# ---------------------------------------------------------------------------
# on_tick, counters, the latency store
# ---------------------------------------------------------------------------

def test_on_tick_runs_at_the_end_of_every_tick(tiny):
    m, hps = tiny
    s = InferenceServer(m.model, m.dense_params(), hps, engine="sync")
    ticks = []
    s.on_tick = lambda: ticks.append(s.counters()["groups_served"])
    s._refresh_tick()
    assert ticks == [0]
    _serve_all(s, [_batch(m.cfg, 4, 1)])
    assert ticks and ticks[-1] >= 1     # the tick after the group
    # the reference's server calls its hook the same way
    j = jserver_mod.InferenceServer(_NoModel(), {}, None)
    jticks = []
    j.on_tick = lambda: jticks.append(1)
    j._refresh_tick()
    assert jticks == [1]


def test_counters_and_reset_match_jax_keys(tiny):
    m, hps = tiny
    s = InferenceServer(m.model, m.dense_params(), hps, engine="sync",
                        slo_ms=1e6)
    _serve_all(s, [_batch(m.cfg, 4, i) for i in range(3)])
    j = jserver_mod.InferenceServer(_NoModel(), {}, None)
    c = s.counters()
    assert set(c) == set(j.counters())
    assert c["requests_delivered"] == 3 and c["groups_served"] >= 1
    assert set(s.latency_percentiles()) == {"p50", "p95", "p99", "p999",
                                            "mean"}
    s.reset_serving_stats()
    c = s.counters()
    assert c["requests_delivered"] == c["groups_served"] == 0
    assert s.latency_percentiles() == {}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ms = np.concatenate([rng.lognormal(1.0, 1.5, 500), [0.0, 1e-4, 7e5]])
    ours, ref = metrics.LatencyHistogram(), jmetrics.LatencyHistogram()
    for v in ms:
        ours.record(float(v))
        ref.record(float(v))
    assert ours.to_dict() == ref.to_dict()
    assert ours.summary() == ref.summary()
    back = jmetrics.LatencyHistogram.from_dict(ours.to_dict())
    assert back.to_dict() == ref.to_dict()
    merged = metrics.LatencyHistogram.from_dict(ref.to_dict()).merge(ours)
    assert merged.count == 2 * len(ms)
    rate, jrate = metrics.WindowedRate(0.5), jmetrics.WindowedRate(0.5)
    for t in rng.uniform(0, 5, 200):
        rate.record(float(t))
        jrate.record(float(t))
    assert rate.series() == jrate.series() and rate.peak() == jrate.peak()


# ---------------------------------------------------------------------------
# the hot-path sanitizer twin
# ---------------------------------------------------------------------------

def _hooked():
    return [getattr(torch.Tensor, n) for n in
            ("item", "cpu", "numpy", "tolist", "__array__")] + [
        torch.cuda.synchronize, devmod.synchronize, _build.build]


def test_hooks_are_noops_when_disarmed():
    before = _hooked()
    assert active_monitor() is None
    with HotPathMonitor() as mon:
        assert active_monitor() is mon
        assert all(a is not b for a, b in zip(_hooked(), before))
    assert all(a is b for a, b in zip(_hooked(), before))
    assert "cpu" not in torch.Tensor.__dict__       # C methods unshadowed
    assert active_monitor() is None


def test_monitor_does_not_nest():
    with HotPathMonitor():
        with pytest.raises(RuntimeError, match="does not nest"):
            HotPathMonitor().__enter__()
    assert active_monitor() is None


def test_counts_each_transfer_once():
    t = torch.arange(4.0)
    host = np.ones(4)
    with HotPathMonitor() as mon:
        np.asarray(host)            # numpy -> numpy: not a tensor
        np.asarray(t)               # __array__ (which calls numpy): one
        t.cpu().numpy()             # the host copy's numpy: one
        t.tolist()
        t.sum().item()
    evs = mon.events()
    assert [e.via for e in evs] == ["Tensor.__array__", "Tensor.cpu",
                                    "Tensor.tolist", "Tensor.item"]
    assert {e.kind for e in evs} == {"d2h"}
    assert {e.device for e in evs} == {"cpu"}
    assert evs[0].shape == (4,)


def test_counts_blocking_sync():
    with HotPathMonitor() as mon:
        devmod.synchronize(torch.device("cpu"))
    assert mon.summary()["block"] == 1 and mon.summary()["d2h"] == 0
    assert mon.events()[0].device == "cpu"


def test_counts_fresh_builds_not_cache_hits(monkeypatch):
    """A fresh load of the kernel library counts once; a loaded library
    is silent. The build and the loader are stubbed (no nvcc here)."""
    class _Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    def fake_build():
        _build.build_info.update(seconds=0.25)
        return "/nonexistent/librepro_kernels.so"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build_info", dict(_build.build_info))
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _Lib())
    with HotPathMonitor() as warm:
        _build.lib()
    assert warm.compiles == 1 and warm.compile_secs == 0.25
    with HotPathMonitor() as again:
        _build.lib()
    assert again.compiles == 0
    assert _build.build is fake_build


def test_hidden_sync_leaky_vs_clean():
    """A loop that reads a value back every step (``.item()``) against
    one that keeps it on the device until the end."""
    def leaky(n):
        acc = 0.0
        for i in range(n):
            acc += (torch.arange(4.0) * i).sum().item()
        return acc

    def clean(n):
        acc = torch.zeros(())
        for i in range(n):
            acc = acc + (torch.arange(4.0) * i).sum()
        return acc.cpu().numpy()

    with HotPathMonitor() as bad:
        leaky(3)
    with HotPathMonitor() as good:
        clean(3)
    assert bad.sync_count == 3
    assert good.sync_count == 1


@pytest.fixture(scope="module", params=["dlrm-criteo", "twotower-criteo"])
def served(request, tmp_path_factory):
    """A deployed stream-engine server for a canonical recipe and a novel
    graph: the pipeline contract must hold for both."""
    m = _fit(_recipe(request.param))
    dep = str(tmp_path_factory.mktemp("san_" + request.param))
    server = m.deploy(dep, cache_capacity=256, max_batch=8)
    assert server.engine == "stream"
    return m, server


def test_stream_engine_one_sync_per_group_zero_builds(served):
    m, server = served
    rows, k = 8, 5
    server.start()
    try:
        for i in range(3):
            server.submit(*_batch(m.cfg, rows, 500 + i)).get(timeout=120)
        server.reset_latencies()
        with HotPathMonitor("stream") as mon:
            for i in range(k):
                out = server.submit(*_batch(m.cfg, rows, 900 + i)) \
                    .get(timeout=120)
                assert not isinstance(out, Exception)
    finally:
        server.stop()
    assert server.counters()["groups_served"] == k
    summ = mon.summary()
    assert summ["syncs"] == k, (summ, mon.events())
    assert summ["compiles"] == 0, summ


def test_admission_control_preserves_hotpath_contract(served):
    m, server = served
    ctl = InferenceServer(m.model, m.dense_params(), server.hps,
                          wide_hps=server.wide_hps, max_batch=8,
                          engine="stream", queue_depth=64,
                          slo_ms=10_000.0, deadline_batching=True)
    rows, k = 8, 5
    ctl.start()
    try:
        for i in range(3):
            out = ctl.submit(*_batch(m.cfg, rows, 600 + i)).get(timeout=120)
            assert not isinstance(out, Exception)
        ctl.reset_serving_stats()
        with HotPathMonitor("stream+admission") as mon:
            for i in range(k):
                out = ctl.submit(*_batch(m.cfg, rows, 950 + i)) \
                    .get(timeout=120)
                assert not isinstance(out, Exception)
    finally:
        ctl.stop()
    c = ctl.counters()
    assert c["groups_served"] == k and c["requests_delivered"] == k
    assert c["requests_shed"] == 0 and c["requests_expired"] == 0
    summ = mon.summary()
    assert summ["syncs"] == k, (summ, mon.events())
    assert summ["compiles"] == 0, summ


def test_stage_sync_reference_syncs_more(served):
    """Positive control: the no-overlap engine fences every table's
    device stage and the dense net, so the twin sees many more syncs than
    groups (proof the one-sync result above is a measurement)."""
    m, server = served
    ref = InferenceServer(m.model, m.dense_params(), server.hps,
                          wide_hps=server.wide_hps, max_batch=8,
                          engine="stage_sync")
    k, rows = 3, 8
    ref._predict_stage_sync(*_batch(m.cfg, rows, 77))
    with HotPathMonitor("stage_sync") as mon:
        for i in range(1, k + 1):
            ref._predict_stage_sync(*_batch(m.cfg, rows, 77 + i))
    tables = len(server.hps.tables)
    assert mon.sync_count == k * (tables + 3)   # per table, pooled, net,
    assert mon.summary()["block"] == k * (tables + 2)   # + the copy


def test_timed_paths_run_uninstrumented():
    """The sanitizer is opt-in: no module of the port outside
    ``analysis/``, and not the kernel timer, imports it, except a
    launcher under its ``sanitize`` flag (``launch/online_train.py
    --sanitize`` and ``launch/serve.py --sanitize``, as the reference's
    launchers)."""
    paths = [os.path.join(ROOT, "tools", "kernel_times.py")]
    src = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(src):
        if os.path.basename(dirpath) == "analysis":
            continue
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]

    def imports_sanitizer(node):
        if isinstance(node, ast.Import):
            return any(a.name.startswith("repro_torch.analysis")
                       for a in node.names)
        return isinstance(node, ast.ImportFrom) and (
            node.module or "").startswith("repro_torch.analysis")

    def visit(node, guarded, path):
        if imports_sanitizer(node):
            assert guarded, path
        if isinstance(node, ast.If) and any(
                isinstance(n, ast.Name) and n.id == "sanitize"
                for n in ast.walk(node.test)):
            for child in node.body:
                visit(child, True, path)
            for child in node.orelse:
                visit(child, guarded, path)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, guarded, path)

    guarded_in = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        visit(tree, False, path)
        if any(imports_sanitizer(n) for n in ast.walk(tree)):
            guarded_in.append(os.path.relpath(path, ROOT))
    assert sorted(guarded_in) == ["src/repro_torch/launch/online_train.py",
                                  "src/repro_torch/launch/serve.py"]
