"""The port's online-training front door against the JAX package's, on the
CPU: the versioned publisher, consumer version tracking, and the
train-while-serving freshness loop (``repro_torch.launch.online_train``).

* The reference's ``tests/test_online.py`` cases on the port.
* Both packages' publishers give byte-equal bus messages for the same
  updates, and each package's consumer reads the other's.
* ``run_online(device="cpu")`` at the reference's sizes: the published
  versions become visible and the live probe converges onto the oracle
  within the reference's 5e-3, with the staged and the cached PS, and
  under the hot-path sanitizer twin one host sync per served group.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core.hps.message_bus import (Consumer, MessageBus, Producer,
                                              _deserialize_versioned,
                                              _serialize)
from repro_torch.online import UpdatePublisher


def test_wire_format_roundtrips_version():
    ids = np.asarray([3, 9, 12], np.int64)
    rows = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    i2, r2, v = _deserialize_versioned(_serialize(ids, rows, 41))
    np.testing.assert_array_equal(i2, ids)
    np.testing.assert_array_equal(r2, rows)
    assert v == 41


def test_publisher_versions_are_monotonic_and_chunked():
    bus = MessageBus()
    pub = UpdatePublisher(bus, "m", max_batch_rows=8)
    rows = np.ones((20, 4), np.float32)
    v1 = pub.publish({"t0": (np.arange(20), rows)})
    v2 = pub.publish({"t0": (np.arange(20), rows * 2),
                      "t1": (np.arange(5), rows[:5])})
    assert (v1, v2) == (1, 2)
    assert pub.last_version() == 2
    assert pub.publish_time(2) is not None
    assert pub.publish_time(3) is None
    # 20 rows at max_batch_rows=8 -> 3 chunks, all stamped v1
    msgs, _ = bus.fetch("hps.m.t0", 0, max_messages=100)
    versions = [_deserialize_versioned(m)[2] for m in msgs]
    assert versions == [1, 1, 1, 2, 2, 2]
    hist = pub.history()
    assert [h["version"] for h in hist] == [1, 2]
    assert hist[1]["tables"] == ["t0", "t1"]
    assert hist[1]["rows"] == 25


def test_consumer_tracks_last_versions():
    bus = MessageBus()
    pub = UpdatePublisher(bus, "m")
    pub.publish({"t0": (np.arange(3), np.ones((3, 2), np.float32))})
    pub.publish({"t1": (np.arange(2), np.ones((2, 2), np.float32))})
    con = Consumer(bus, "m")
    applied = {}
    con.poll(lambda t, i, r: applied.setdefault(t, 0))
    assert con.last_versions == {"t0": 1, "t1": 2}
    # legacy unversioned producer messages read back as version 0 and
    # never regress a table's recorded version
    prod = Producer(bus, "m")
    prod.send("t0", np.arange(2), np.ones((2, 2), np.float32))
    prod.flush()
    con.poll(lambda t, i, r: None)
    assert con.last_versions["t0"] == 1


def test_empty_tables_are_skipped():
    bus = MessageBus()
    pub = UpdatePublisher(bus, "m")
    v = pub.publish({"t0": (np.empty(0, np.int64),
                            np.empty((0, 4), np.float32)),
                     "t1": (np.arange(2), np.ones((2, 4), np.float32))})
    assert bus.topics() == ["hps.m.t1"]
    rec = pub.history()[0]
    assert (rec["version"], rec["tables"], rec["rows"]) == (v, ["t1"], 2)


def _updates(seed):
    rng = np.random.default_rng(seed)
    return {f"t{i}": (rng.choice(1000, n, replace=False).astype(np.int64),
                      rng.normal(size=(n, 8)).astype(np.float32))
            for i, n in enumerate((37, 0, 11))}


def test_publisher_messages_byte_equal_to_jax():
    """The same update sets through both packages' publishers: every topic
    holds the same bytes, and each package's consumer reads the other's
    bus to the same rows and versions."""
    from repro.core.hps.message_bus import Consumer as JConsumer
    from repro.core.hps.message_bus import MessageBus as JBus
    from repro.online import UpdatePublisher as JPublisher
    bus, jbus = MessageBus(), JBus()
    pub, jpub = (UpdatePublisher(bus, "m", max_batch_rows=16),
                 JPublisher(jbus, "m", max_batch_rows=16))
    for seed in (1, 2, 3):
        assert pub.publish(_updates(seed)) == jpub.publish(_updates(seed))
    assert bus.topics() == jbus.topics()
    for topic in bus.topics():
        assert bus.fetch(topic, 0, 1000)[0] == jbus.fetch(topic, 0, 1000)[0]
    for con in (Consumer(jbus, "m"), JConsumer(bus, "m")):
        got = {}
        con.poll(lambda t, i, r: got.setdefault(t, []).append((i, r)))
        assert con.last_versions == {"t0": 3, "t2": 3}
        assert sum(len(i) for i, _ in got["t0"]) == 3 * 37


def test_publish_cache_sends_the_resident_rows():
    """``publish_cache``: every resident row of an ETC, one version."""
    from repro_torch.configs.base import EmbeddingTableConfig
    from repro_torch.core.etc.cache import EmbeddingTrainingCache
    from repro_torch.core.etc.parameter_server import StagedPS
    tabs = [EmbeddingTableConfig(f"t{i}", 50, 4) for i in range(2)]
    ps = StagedPS(tabs)
    etc = EmbeddingTrainingCache(tabs, 8, ps, device="cpu")
    params, _ = etc.prepare(etc.init_params(), np.asarray(
        [[[3], [4]], [[9], [-1]]], np.int32))
    bus = MessageBus()
    v = UpdatePublisher(bus, "m").publish_cache(etc, params)
    ids, rows, version = _deserialize_versioned(
        bus.fetch("hps.m.t0", 0)[0][0])
    assert version == v == 1
    np.testing.assert_array_equal(ids, [3, 9])
    np.testing.assert_array_equal(rows, ps.pull("t0", ids))


@pytest.mark.parametrize("ps,sanitize", [("staged", False),
                                         ("cached", True)])
def test_train_while_serving_freshness_loop(tmp_path, ps, sanitize):
    """The loop end to end on the CPU at the reference's test sizes:
    deploy LIVE, run incremental ETC passes, publish at each boundary,
    and require the updates to become visible in live predictions
    (converging onto the freshly-trained oracle within 5e-3) with no
    redeploy; ``sanitize`` also holds one host sync per served group
    while the consumer loop applies updates."""
    from repro_torch.launch.online_train import run_online
    m = run_online(base_steps=10, online_steps=10, passes=2,
                   cache_rows=256, requests=2, batch=128, ps=ps,
                   ps_root=str(tmp_path / "ps") if ps == "cached" else None,
                   deploy_dir=str(tmp_path / "bundle"), sanitize=sanitize,
                   verbose=False, device="cpu")
    assert m["versions_published"] == 2
    assert m["updates_applied"] >= 2          # both passes consumed
    assert m["rows_refreshed"] > 0            # L1 actually refreshed
    assert m["final_dist"] < 5e-3             # converged onto oracle
    assert m["final_dist"] < m["baseline_dist"]
    assert m["freshness_lag_s"] < 120
    assert m["etc_evictions"] > 0


def test_online_train_matches_jax_cache_traffic(tmp_path):
    """The same loop in both packages stages the same ids: equal pulls and
    evictions (the caches see the same reader and keysets)."""
    from repro.launch.online_train import run_online as jrun
    from repro_torch.launch.online_train import run_online
    kw = dict(base_steps=4, online_steps=6, passes=2, cache_rows=200,
              requests=1, batch=64, verbose=False)
    got = run_online(deploy_dir=str(tmp_path / "p"), device="cpu", **kw)
    want = jrun(deploy_dir=str(tmp_path / "j"), **kw)
    assert (got["etc_pulls"], got["etc_evictions"]) == \
        (want["etc_pulls"], want["etc_evictions"])
    assert got["versions_published"] == want["versions_published"] == 2


def test_launcher_main_runs_on_cpu(capsys):
    from repro_torch.launch.online_train import main
    main(["--device", "cpu", "--base-steps", "4", "--online-steps", "4",
          "--passes", "2", "--requests", "1"])
    out = capsys.readouterr().out
    assert "freshness: v2 visible" in out
