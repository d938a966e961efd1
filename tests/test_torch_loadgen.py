"""The port's traffic harness (``repro_torch.loadgen``) against the
reference's, on the CPU.

- The reference's ``tests/test_loadgen.py`` workload and trace cases on
  the port (determinism, arrivals, shapes, mix, validation, hot-set
  drift, trace round trip).
- For the same ``WorkloadConfig`` and shapes the port's stream equals the
  reference's ``Workload`` bit for bit (arrival times, models, ``dense``,
  ``cat``); a trace written by either package replays in the other bit
  for bit, and either package rejects a foreign header.
- ``OpenLoopDriver`` against a fake ``submit`` whose handles resolve
  after set delays or with ``ServerOverloaded``: delivered, shed, errors
  and lost counts are exact and latency runs from the scheduled time;
  then against the port's smoke DLRM ``InferenceServer`` with admission
  armed: every handle resolves.
"""
import pytest

torch = pytest.importorskip("torch")

import queue
import threading
import time
from collections import Counter

import numpy as np

from repro.loadgen import workload as jworkload
from repro_torch.configs import dlrm_criteo
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.loadgen import (ModelShape, OpenLoopDriver, Request,
                                 Workload, WorkloadConfig, record_trace,
                                 replay_trace)
from repro_torch.serve.server import ServerOverloaded

SHAPE = ModelShape(vocab_sizes=(4000, 600), hotness=(4, 1), num_dense=3)


def _stream(cfg, shapes=None):
    return list(Workload(cfg, shapes or {"m": SHAPE}))


def _same(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.t == rb.t and ra.model == rb.model
        assert rb.dense.dtype == np.float32 and rb.cat.dtype == np.int32
        np.testing.assert_array_equal(ra.dense, rb.dense)
        np.testing.assert_array_equal(ra.cat, rb.cat)


# ---------------------------------------------------------------------------
# the reference's workload cases on the port
# ---------------------------------------------------------------------------

def test_same_seed_identical_stream():
    cfg = WorkloadConfig(qps=200, duration_s=1.0, rows=4, seed=3)
    a, b = _stream(cfg), _stream(cfg)
    assert len(a) > 50
    _same(a, b)


def test_different_seed_different_stream():
    mk = lambda s: WorkloadConfig(qps=200, duration_s=1.0, seed=s)
    a, b = _stream(mk(0)), _stream(mk(1))
    assert [r.t for r in a] != [r.t for r in b]


@pytest.mark.parametrize("arrival", ["poisson", "constant"])
def test_arrivals_monotone_and_bounded(arrival):
    cfg = WorkloadConfig(qps=100, duration_s=2.0, arrival=arrival)
    ts = [r.t for r in _stream(cfg)]
    assert ts == sorted(ts)
    assert all(0 < t <= cfg.duration_s for t in ts)
    # offered rate lands near the target (exactly, for constant)
    assert len(ts) == pytest.approx(200, rel=0.3)


def test_request_shapes_and_padding():
    cfg = WorkloadConfig(qps=50, duration_s=0.5, rows=6)
    for r in _stream(cfg):
        assert r.dense.shape == (6, SHAPE.num_dense)
        assert r.cat.shape == (6, SHAPE.num_tables, SHAPE.max_hot)
        # table 1 has hotness 1: the rest of its slots are -1 padded
        assert (r.cat[:, 1, 1:] == -1).all()
        assert (r.cat[:, 0, :] >= 0).all()
        assert (r.cat[:, 0, :] < SHAPE.vocab_sizes[0]).all()


def test_mix_routes_by_weight():
    shapes = {"a": SHAPE, "b": SHAPE}
    cfg = WorkloadConfig(qps=2000, duration_s=1.0, rows=1, seed=5,
                         mix={"a": 3.0, "b": 1.0})
    counts = Counter(r.model for r in _stream(cfg, shapes))
    assert counts["a"] / counts["b"] == pytest.approx(3.0, rel=0.25)


@pytest.mark.parametrize("make,match", [
    (lambda: WorkloadConfig(qps=1, duration_s=1, arrival="burst"),
     "arrival"),
    (lambda: WorkloadConfig(qps=1, duration_s=1, zipf_a=1.0), "zipf_a"),
    (lambda: WorkloadConfig(qps=0, duration_s=1), "positive"),
    (lambda: Workload(WorkloadConfig(qps=1, duration_s=1,
                                     mix={"nope": 1.0}), {"m": SHAPE}),
     "unknown models"),
    (lambda: Workload(WorkloadConfig(qps=1, duration_s=1,
                                     mix={"m": 0.0}), {"m": SHAPE}),
     "positive"),
    (lambda: Workload(WorkloadConfig(qps=1, duration_s=1), {}),
     "at least one"),
], ids=["arrival", "zipf_a", "qps", "mix-name", "mix-weight", "no-shape"])
def test_config_validation(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def _hot_ids(reqs, top=20):
    """The top-N most frequent ids of table 0 across a request window."""
    c = Counter()
    for r in reqs:
        c.update(int(x) for x in r.cat[:, 0, :].ravel())
    return {i for i, _ in c.most_common(top)}


@pytest.mark.parametrize("drift,max_overlap,min_overlap", [
    (0.0, 1.0, 0.5),      # stationary: early and late hot sets agree
    (0.4, 0.25, 0.0),     # drifting: the late hot set has moved on
])
def test_drift_moves_hot_set(drift, max_overlap, min_overlap):
    cfg = WorkloadConfig(qps=150, duration_s=2.0, rows=8, seed=11,
                         arrival="constant", zipf_a=1.5,
                         drift_per_s=drift)
    reqs = _stream(cfg)
    early = _hot_ids([r for r in reqs if r.t < 0.3])
    late = _hot_ids([r for r in reqs if r.t > cfg.duration_s - 0.3])
    overlap = len(early & late) / len(early | late)
    assert min_overlap <= overlap <= max_overlap, overlap


def test_drift_preserves_id_range():
    cfg = WorkloadConfig(qps=100, duration_s=1.0, drift_per_s=0.9)
    for r in _stream(cfg):
        assert (r.cat[:, 0, :] >= 0).all()
        assert (r.cat[:, 0, :] < SHAPE.vocab_sizes[0]).all()


def test_model_shape_from_config():
    cfg = dlrm_criteo.build_model(smoke=True).to_recsys_config()
    shape = ModelShape.from_config(cfg)
    assert shape.vocab_sizes == tuple(t.vocab_size for t in cfg.tables)
    assert shape.num_tables == 6 and shape.max_hot == 1
    assert shape.num_dense == 13


# ---------------------------------------------------------------------------
# the same stream and traces as the reference
# ---------------------------------------------------------------------------

#: (config kwargs, shapes): one model, a drifting two-model mix with a
#: multi-hot table, constant arrivals
STREAMS = {
    "one-model": (dict(qps=300, duration_s=0.5, rows=4, seed=3),
                  {"m": ((4000, 600), (4, 1), 3)}),
    "mix-drift": (dict(qps=400, duration_s=0.5, rows=2, seed=7,
                       zipf_a=1.3, drift_per_s=0.2,
                       mix={"dlrm": 3.0, "dcn": 1.0}),
                  {"dlrm": ((1000, 584, 30, 7), (1, 3, 1, 2), 13),
                   "dcn": ((999, 5), (1, 1), 13)}),
    "constant": (dict(qps=100, duration_s=0.4, rows=8, seed=1,
                      arrival="constant"),
                 {"m": ((50,), (2,), 1)}),
}


def _both(name):
    kw, raw = STREAMS[name]
    port = Workload(WorkloadConfig(**kw),
                    {n: ModelShape(*s) for n, s in raw.items()})
    ref = jworkload.Workload(jworkload.WorkloadConfig(**kw),
                             {n: jworkload.ModelShape(*s)
                              for n, s in raw.items()})
    return list(port), list(ref)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_equals_the_reference_bit_for_bit(name):
    port, ref = _both(name)
    assert len(port) > 10
    _same(ref, port)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_traces_replay_in_the_other_package(tmp_path, writer):
    port, ref = _both("mix-drift")
    path = str(tmp_path / "trace.jsonl")
    if writer == "port":
        n = record_trace(path, port)
        back = list(jworkload.replay_trace(path))
    else:
        n = jworkload.record_trace(path, ref)
        back = list(replay_trace(path))
    assert n == len(port)
    _same(port, back)
    # and the package's own replay reads the same bytes
    _same(port, list(replay_trace(path)))


@pytest.mark.parametrize("replay", [replay_trace, jworkload.replay_trace],
                         ids=["port", "reference"])
def test_trace_rejects_foreign_file(tmp_path, replay):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        f.write('{"format": "something-else"}\n')
    with pytest.raises(ValueError, match="repro-loadtrace-v1"):
        list(replay(path))


# ---------------------------------------------------------------------------
# the open-loop driver
# ---------------------------------------------------------------------------

def _req(t, model="m"):
    return Request(t=t, model=model, dense=np.zeros((1, 1), np.float32),
                   cat=np.zeros((1, 1, 1), np.int32))


class _FakeServer:
    """``submit`` whose handle resolves after ``delay_s`` on a timer
    thread with ``outcome`` (an array, ``ServerOverloaded``, another
    exception) or never (``None``)."""

    def __init__(self, plan):
        self.plan = list(plan)            # (delay_s, outcome) per submit
        self.timers = []

    def submit(self, model, dense, cat):
        delay, outcome = self.plan.pop(0)
        q = queue.Queue(maxsize=1)
        if outcome is not None:
            t = threading.Timer(delay, q.put, args=(outcome,))
            t.start()
            self.timers.append(t)
        return q


def test_driver_counts_are_exact_against_a_fake_server():
    ok = np.zeros(1, np.float32)
    plan = [(0.0, ok), (0.05, ok), (0.0, ServerOverloaded("queue full")),
            (0.0, RuntimeError("boom")), (0.0, None), (0.2, ok)]
    reqs = [_req(0.01 * (i + 1), "a" if i < 4 else "b")
            for i in range(len(plan))]
    fake = _FakeServer(plan)
    drv = OpenLoopDriver(fake.submit, slo_ms=100.0, drain_timeout_s=0.6)
    rep = drv.run(reqs)
    for t in fake.timers:
        t.join()
    a, b = rep["models"]["a"], rep["models"]["b"]
    assert rep["scheduled"] == 6
    assert (a["scheduled"], a["delivered"], a["shed_observed"],
            a["errors"], a["lost"]) == (4, 2, 1, 1, 0)
    assert (b["scheduled"], b["delivered"], b["shed_observed"],
            b["errors"], b["lost"]) == (2, 1, 0, 0, 1)
    # b's 200 ms response violates the 100 ms client-side SLO
    assert a["slo_violations_observed"] == 0
    assert b["slo_violations_observed"] == 1
    assert sum(n for _, n in b["delivered_qps"]) == 1.0


def test_driver_latency_runs_from_the_scheduled_time():
    """A submit that blocks holds every later request past its schedule:
    the delay counts against their latency (no coordinated omission)."""
    ok = np.zeros(1, np.float32)

    def blocking_submit(model, dense, cat):
        time.sleep(0.1)               # the driver falls behind here
        q = queue.Queue(maxsize=1)
        q.put(ok)
        return q

    reqs = [_req(0.001), _req(0.002), _req(0.003)]
    rep = OpenLoopDriver(blocking_submit, poll_s=1e-3).run(reqs)
    m = rep["models"]["m"]
    assert m["delivered"] == 3 and m["lost"] == 0
    # the third request was scheduled at 3 ms and submitted after ~300 ms
    assert rep["max_submit_lag_ms"] >= 150.0
    assert m["latency_ms"]["p999"] >= 250.0
    assert m["latency_ms"]["p50"] >= 150.0


def test_driver_against_the_ports_server_with_admission(tmp_path):
    m = dlrm_criteo.build_model(smoke=True)
    m.compile(device="cpu")
    m._params = m.model.init(torch.Generator().manual_seed(0))
    server = m.deploy(str(tmp_path), cache_capacity=256, max_batch=32)
    try:
        warm = SyntheticCTR(m.cfg, 8).batch(0)
        server.predict(warm["dense"], warm["cat"])
        server.set_admission(queue_depth=4, slo_ms=50.0)
        server.start()
        wl = Workload(WorkloadConfig(qps=400, duration_s=0.5, rows=8,
                                     seed=2),
                      {m.name: ModelShape.from_config(m.cfg)})
        rep = OpenLoopDriver(
            lambda _n, dense, cat: server.submit(dense, cat),
            slo_ms=50.0, drain_timeout_s=30.0).run(wl)
    finally:
        server.close()
    st = rep["models"][m.name]
    assert st["lost"] == 0 and st["errors"] == 0
    assert st["delivered"] + st["shed_observed"] == st["scheduled"] \
        == rep["scheduled"] > 0
    c = server.counters()
    assert c["requests_delivered"] == st["delivered"]
    assert c["requests_shed"] + c["requests_expired"] \
        == st["shed_observed"]
