"""The HPS online-update path and the one-device striped L1, the port
against the JAX package on the same numpy inputs.

- Message bus: the wire bytes equal the reference's; a JAX producer is
  read by a port consumer and the reverse; offsets, the row-threshold
  flush and ``last_versions`` (a version-0 message never lowers it).
- ``ShardedPayloadStore(shards=N)`` at a capacity no N of 2, 3, 4
  divides, f32 / f16 / int8: shapes, snapshot bytes and scales after the
  same scatters equal the reference's, and ``gather`` /
  ``ops.sharded_cache_gather`` equal the reference's mesh-less
  ``sharded_cache_gather`` bit for bit. Stripes across a cache mesh of
  devices read the same rows as the reference's one-device store (the
  mesh half against the reference's four-device one:
  ``tests/test_torch_hps_mesh.py``).
- ``DeviceEmbeddingCache``: the same query / ``mark_dirty`` /
  ``refresh_chunk`` / ``resize`` sequence gives the reference's resident
  ids, counters and payload bytes; the scheduler's rules (hot before
  cold within the budget, never over it, insertion clears dirty, only
  residents get marked, the full re-pull, the refresh thread).
- ``HPS``: a striped HPS's pooled reads (``lookup``, ``pipelined``,
  ``lookup_stream``, ``lookup_stage_sync``) are bit-exact (f32) to the
  reference's striped HPS and to the port's unstriped one; the same bus
  messages followed by ``apply_updates`` + ``refresh_step`` leave both
  packages reading the same bytes (f32 and int8, whose refreshed rows
  requantize from the f32 lower levels); an update hammer on a stream
  never tears a row.
- The server's loop drives the refresh (``stream`` and ``sync``) and
  ``update_versions`` reports what landed; a JAX bundle deployed with
  ``cache_shards=2, refresh_budget=64`` is served by the port (f32 L1
  reads bit-exact to the JAX server's, before and after the same
  updates), and a port bundle with those settings by the JAX package.
"""
import pytest

torch = pytest.importorskip("torch")

import json
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.analysis import LockOrderRecorder
from repro.configs import dlrm_criteo as jrecipe
from repro.configs.base import EmbeddingTableConfig as JTable
from repro.core.hps import message_bus as jbus
from repro.core.hps.embedding_cache import DeviceEmbeddingCache as JCache
from repro.core.hps.hps import HPS as JHPS
from repro.core.hps.payload_store import ShardedPayloadStore as JStore
from repro.core.hps.payload_store import row_bytes as j_row_bytes
from repro.core.hps.persistent_db import PersistentDB as JPDB
from repro.kernels import ops as jops
from repro.launch.serve import build_server_from_config as jbuild
from repro_torch import api
from repro_torch.configs import registry
from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.core.hps import message_bus as pbus
from repro_torch.core.hps.embedding_cache import DeviceEmbeddingCache
from repro_torch.core.hps.hps import HPS
from repro_torch.core.hps.payload_store import ShardedPayloadStore, row_bytes
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_server_from_config
from repro_torch.models.recsys.model import RecsysModel
from repro_torch.serve.server import InferenceServer, write_bundle

#: served probabilities of the two packages (the bf16 bound the JAX
#: server is held to in ``examples/quickstart.py``)
PROB_TOL = 2e-2
#: a capacity that none of 2, 3 and 4 stripes divides
CAP = 61


# ---------------------------------------------------------------------------
# message bus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,version", [(0, 4, 0), (1, 1, 3), (3, 16, 7),
                                         (257, 8, 2 ** 40)])
def test_bus_bytes_equal_jax(n, d, version):
    rng = np.random.default_rng(n * 31 + d)
    ids = rng.integers(0, 2 ** 62, size=n).astype(np.int64)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    msg = pbus._serialize(ids, rows, version)
    assert msg == jbus._serialize(ids, rows, version)
    for de in (pbus._deserialize_versioned, jbus._deserialize_versioned):
        i2, r2, v2 = de(msg)
        np.testing.assert_array_equal(i2, ids)
        np.testing.assert_array_equal(r2, rows)
        assert v2 == version and i2.dtype == np.int64
    i2, r2 = pbus._deserialize(msg)
    i2[:1], r2[:1] = 99, 99.0   # writable copies (a frombuffer view raises)


@pytest.mark.parametrize("prod_mod,cons_mod", [(jbus, pbus), (pbus, jbus)],
                         ids=["jax_to_port", "port_to_jax"])
def test_producer_and_consumer_across_packages(prod_mod, cons_mod):
    bus = prod_mod.MessageBus()
    prod = prod_mod.Producer(bus, "m", max_batch_rows=100)
    rng = np.random.default_rng(2)
    sent = {}
    for t in ("t0", "t1"):
        ids = rng.integers(0, 1000, size=5)
        rows = rng.normal(size=(5, 4)).astype(np.float32)
        prod.send(t, ids, rows)
        sent[t] = [(ids, rows)]
    prod.flush(version=5)
    later = (rng.integers(0, 1000, size=2),
             rng.normal(size=(2, 4)).astype(np.float32))
    prod.send("t0", *later)
    prod.flush("t0")                    # a legacy version-0 message
    sent["t0"].append(later)
    cons = cons_mod.Consumer(bus, "m")
    got = {}
    assert cons.poll(lambda t, i, r: got.setdefault(t, []).append(
        (i, r))) == 3
    for t, msgs in sent.items():
        assert len(got[t]) == len(msgs)
        for (gi, gr), (si, sr) in zip(got[t], msgs):
            np.testing.assert_array_equal(gi, si)
            np.testing.assert_array_equal(gr, sr)
    assert cons.last_versions == {"t0": 5, "t1": 5}   # v0 never lowers


def test_consumer_polls_topics_with_offsets():
    bus = pbus.MessageBus()
    prod = pbus.Producer(bus, "m")
    for t, base in (("t0", 0), ("t1", 100)):
        prod.send(t, np.asarray([base, base + 1]),
                  np.full((2, 4), float(base), np.float32))
    prod.flush()
    other = pbus.Producer(bus, "other_model")   # invisible to "m"
    other.send("t0", np.asarray([7]), np.zeros((1, 4), np.float32))
    other.flush()
    cons = pbus.Consumer(bus, "m")
    assert sorted(cons.discover()) == ["hps.m.t0", "hps.m.t1"]
    seen = {}
    assert cons.poll(lambda t, ids, rows: seen.setdefault(t, []).extend(
        ids.tolist())) == 2
    assert seen == {"t0": [0, 1], "t1": [100, 101]}
    assert cons.last_versions == {"t0": 0, "t1": 0}
    prod.send("t1", np.asarray([102]), np.zeros((1, 4), np.float32))
    prod.flush("t1", version=2)
    again = {}
    assert cons.poll(lambda t, ids, rows: again.setdefault(t, []).extend(
        ids.tolist())) == 1
    assert again == {"t1": [102]}
    assert cons.last_versions == {"t0": 0, "t1": 2}
    assert cons.poll(lambda *a: None) == 0


def test_producer_flushes_at_row_threshold_and_fetch_windows():
    bus = pbus.MessageBus()
    prod = pbus.Producer(bus, "m", max_batch_rows=4)
    for i in range(3):
        prod.send("t0", np.asarray([i]), np.ones((1, 2), np.float32))
    assert bus.topics() == []                  # below threshold: buffered
    prod.send("t0", np.asarray([3]), np.ones((1, 2), np.float32))
    msgs, off = bus.fetch("hps.m.t0", 0)
    assert len(msgs) == 1 and off == 1         # one coalesced message
    ids, rows = pbus._deserialize(msgs[0])
    assert ids.tolist() == [0, 1, 2, 3] and rows.shape == (4, 2)
    for i in range(5):
        bus.publish("tp", bytes([i]))
    msgs, off = bus.fetch("tp", 1, max_messages=2)
    assert msgs == [bytes([1]), bytes([2])] and off == 3
    msgs, off = bus.fetch("tp", off, max_messages=64)
    assert msgs == [bytes([3]), bytes([4])] and off == 5


# ---------------------------------------------------------------------------
# the striped payload store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("payload_dtype", ["f32", "f16", "int8"])
def test_striped_store_matches_jax(shards, payload_dtype):
    p = ShardedPayloadStore(CAP, 8, shards=shards,
                            payload_dtype=payload_dtype, device="cpu")
    j = JStore(CAP, 8, shards=shards, payload_dtype=payload_dtype)
    assert (p.local_rows, p.phys_rows) == (j.local_rows, j.phys_rows)
    assert CAP % shards and p.phys_rows > CAP
    rng = np.random.default_rng(shards)
    for _ in range(4):
        slots = rng.choice(CAP, size=int(rng.integers(1, 40)),
                           replace=False).astype(np.int64)
        rows = rng.normal(size=(len(slots), 8)).astype(np.float32)
        p.scatter(slots, rows)
        j.scatter(slots, rows)
    (pp, ps), (jp, js) = p.snapshot(), j.snapshot()
    assert tuple(pp.shape) == jp.shape == (shards, j.local_rows, 8)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert (ps is None) == (js is None) == (payload_dtype != "int8")
    if ps is not None:
        assert tuple(ps.shape) == js.shape
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    q = rng.integers(-1, CAP, size=50)
    want = np.asarray(jops.sharded_cache_gather(jp, q, scales=js))
    q32 = q.astype(np.int32)
    for got in (p.gather(p.snapshot(), q32),
                ops.sharded_cache_gather(pp, q32, scales=ps),
                ops.sharded_cache_gather(pp, torch.from_numpy(q32),
                                         scales=ps)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_flatten_striped_slots_matches_jax():
    stripes = jnp.zeros((3, 24, 2))
    slots = np.random.default_rng(5).integers(-1, 72, size=(7, 5))
    want = np.asarray(jops.flatten_striped_slots(stripes, jnp.asarray(
        slots)))
    tstripes = torch.zeros((3, 24, 2))
    np.testing.assert_array_equal(ops.flatten_striped_slots(tstripes, slots),
                                  want)
    np.testing.assert_array_equal(ops.flatten_striped_slots(
        tstripes, torch.from_numpy(slots.astype(np.int32))).numpy(), want)
    flat, scales = ops.striped_view((tstripes, torch.ones((3, 24))))
    assert tuple(flat.shape) == (72, 2) and tuple(scales.shape) == (72,)


def test_store_validation_and_row_bytes(tmp_path):
    for dt in ("f32", "f16", "int8"):
        for d in (1, 16, 128):
            assert row_bytes(d, dt) == j_row_bytes(d, dt)
    with pytest.raises(ValueError, match="payload_dtype"):
        row_bytes(8, "bf16")
    with pytest.raises(ValueError, match="shards"):
        ShardedPayloadStore(4, 8, shards=8, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        ShardedPayloadStore(16, 8, shards=0, device="cpu")
    # stripes across a cache mesh of devices (here two CPU entries) read
    # what the reference's store reads, and a mesh they do not tile raises
    rng = np.random.default_rng(9)
    slots = np.arange(0, 64, 5, dtype=np.int64)
    rows = rng.normal(size=(len(slots), 8)).astype(np.float32)
    for dt in ("f32", "int8"):
        st = ShardedPayloadStore(64, 8, shards=2, mesh=["cpu", "cpu"],
                                 payload_dtype=dt, device="cpu")
        js = JStore(64, 8, shards=2, payload_dtype=dt)
        st.scatter(slots, rows)
        js.scatter(slots, rows)
        np.testing.assert_array_equal(
            st.gather(st.snapshot(), slots.astype(np.int32)).numpy(),
            np.asarray(js.gather(js.snapshot(), jnp.asarray(slots))))
    with pytest.raises(ValueError, match="tile"):
        ShardedPayloadStore(64, 8, shards=3, mesh=["cpu", "cpu"],
                            device="cpu")
    pdb = PersistentDB(str(tmp_path))
    table = rng.normal(size=(50, 4)).astype(np.float32)
    pdb.create_table("m", "t0", 50, 4, initial=table)
    hps = HPS("m", [EmbeddingTableConfig("t0", 50, 4, hotness=2)], pdb,
              cache_shards=2, cache_mesh=["cpu", "cpu"])
    cat = rng.integers(-1, 50, (6, 1, 2)).astype(np.int32)
    want = np.where((cat >= 0)[..., None], table[cat], 0).sum(2)
    np.testing.assert_allclose(hps.lookup(cat).numpy(), want, rtol=1e-6,
                               atol=1e-6)
    c = DeviceEmbeddingCache(8, 4, shards=4, fetch_fn=lambda i: None,
                             device="cpu")
    with pytest.raises(ValueError, match="shard count"):
        c.resize(2)


# ---------------------------------------------------------------------------
# the cache's refresh scheduler and resize, against the reference
# ---------------------------------------------------------------------------

def _store_rows(vocab=200, dim=8, seed=0):
    return np.random.default_rng(seed).normal(
        size=(vocab, dim)).astype(np.float32)


def _zipf(rng, vocab, size):
    u = rng.random(size)
    x = (u * ((vocab + 1.0) ** -0.2 - 1.0) + 1.0) ** (1 / -0.2)
    return np.clip(np.floor(x).astype(np.int64) - 1, 0, vocab - 1)


def _same_cache(p, j):
    np.testing.assert_array_equal(p.resident_ids(), j.resident_ids())
    assert p.counters() == j.counters()
    assert p.refresh_backlog() == j.refresh_backlog()
    assert p.capacity == j.capacity and p.hit_rate == j.hit_rate
    (pp, ps), (jp, js) = p.payload, j.payload
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    if ps is not None:
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_refresh_and_resize_sequence_matches_jax(shards, payload_dtype):
    rows = _store_rows()
    kw = dict(fetch_fn=lambda ids: rows[ids], shards=shards,
              refresh_chunk_rows=7, payload_dtype=payload_dtype)
    p = DeviceEmbeddingCache(32, 8, device="cpu", **kw)
    j = JCache(32, 8, **kw)
    rng = np.random.default_rng(9)

    def query(n=5):
        for _ in range(n):
            ids = _zipf(rng, 200, int(rng.integers(1, 48)))
            ids[rng.random(len(ids)) < 0.1] = -1
            np.testing.assert_array_equal(p.query(ids).numpy(),
                                          np.asarray(j.query(ids)))

    query()
    _same_cache(p, j)
    changed = np.unique(_zipf(rng, 200, 40))
    rows[changed] += 1.0                   # the lower levels move
    assert p.mark_dirty(changed) == j.mark_dirty(changed) > 0
    for budget in (3, 5, None):
        assert p.refresh_chunk(budget) == j.refresh_chunk(budget)
        _same_cache(p, j)
    query(3)
    assert p.refresh_once(4) == j.refresh_once(4) > 0
    _same_cache(p, j)
    for cap in (12, 40):                   # shrink, then grow
        assert p.resize(cap) == j.resize(cap)
        _same_cache(p, j)
        query(3)
        _same_cache(p, j)
    assert p.mark_all_dirty() == j.mark_all_dirty()
    while j.refresh_backlog():
        assert p.refresh_chunk(6) == j.refresh_chunk(6)
    _same_cache(p, j)


@pytest.mark.parametrize("shards", [1, 2])
def test_refresh_hot_row_before_cold_row_within_budget(shards):
    rows = _store_rows(vocab=20, dim=4)
    c = DeviceEmbeddingCache(8, 4, fetch_fn=lambda ids: rows[ids],
                             shards=shards, device="cpu")
    for _ in range(5):
        c.query(np.asarray([3]))              # id 3 becomes hot
    c.query(np.asarray([7]))                  # id 7 stays cold
    orig7 = rows[7].copy()
    rows[3], rows[7] = 111.0, 222.0           # both go stale below
    assert c.mark_dirty(np.asarray([3, 7])) == 2
    assert c.refresh_backlog() == 2
    assert c.refresh_chunk(budget=1) == 1     # the budget holds
    np.testing.assert_array_equal(c.query(np.asarray([3])).numpy()[0],
                                  np.full(4, 111.0, np.float32))
    np.testing.assert_array_equal(c.query(np.asarray([7])).numpy()[0],
                                  orig7)      # the cold one still stale
    assert c.refresh_backlog() == 1
    assert c.refresh_chunk(budget=4) == 1
    np.testing.assert_array_equal(c.query(np.asarray([7])).numpy()[0],
                                  np.full(4, 222.0, np.float32))
    assert c.refresh_backlog() == 0
    assert c.rows_refreshed == 2 and c.refresh_chunks == 2


@pytest.mark.parametrize("shards", [1, 2])
def test_refresh_chunk_never_exceeds_budget(shards):
    rows = _store_rows(vocab=64, dim=4)
    c = DeviceEmbeddingCache(32, 4, fetch_fn=lambda ids: rows[ids],
                             shards=shards, device="cpu")
    c.query(np.arange(32))
    fetched = []
    orig = c.fetch_fn
    c.fetch_fn = lambda ids: fetched.append(len(ids)) or orig(ids)
    c.mark_all_dirty()
    while c.refresh_backlog():
        c.refresh_chunk(budget=5)
    assert max(fetched) <= 5                  # a chunk's fetch is bounded
    assert sum(fetched) == 32                 # every resident row covered
    assert c.rows_refreshed == 32


@pytest.mark.parametrize("shards", [1, 2])
def test_mark_dirty_touches_only_residents_and_insertion_clears_it(shards):
    rows = _store_rows(vocab=30, dim=4)
    c = DeviceEmbeddingCache(8, 4, fetch_fn=lambda ids: rows[ids],
                             shards=shards, device="cpu")
    c.query(np.asarray([1, 2]))
    assert c.mark_dirty(np.asarray([1, 25, 26])) == 1
    assert c.refresh_backlog() == 1
    # a slot reused by a fresh insertion does not inherit the evicted
    # row's dirty bit (the new row just came from the lower levels)
    small = DeviceEmbeddingCache(2, 4, fetch_fn=lambda ids: rows[ids],
                                 shards=shards, device="cpu")
    small.query(np.asarray([1, 2]))
    small.mark_all_dirty()
    small.query(np.asarray([3, 3, 3]))        # evicts one dirty slot
    assert small.refresh_backlog() == 1       # only the survivor is dirty


@pytest.mark.parametrize("shards", [1, 2])
def test_refresh_once_and_the_refresh_thread(shards):
    rows = _store_rows(vocab=10, dim=4)
    c = DeviceEmbeddingCache(8, 4, fetch_fn=lambda ids: rows[ids],
                             shards=shards, refresh_chunk_rows=2,
                             device="cpu")
    c.query(np.asarray([0, 1, 2, 3, 4]))
    rows[:5] = 77.0
    assert c.refresh_once() == 5              # chunked, every row
    np.testing.assert_array_equal(c.query(np.arange(5)).numpy(),
                                  np.full((5, 4), 77.0, np.float32))
    rows[:5] = 88.0
    before = c.counters()["rows_refreshed"]
    c.start_refresh(0.01)                     # refresh_once on a thread
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                c.counters()["rows_refreshed"] < before + 5:
            time.sleep(0.01)
    finally:
        c.stop_refresh()
    assert c._refresh_thread is None
    np.testing.assert_array_equal(c.query(np.arange(5)).numpy(), rows[:5])


# ---------------------------------------------------------------------------
# the HPS: striped reads and online updates, against the reference
# ---------------------------------------------------------------------------

VOCAB, DIM, T, HOT = 120, 8, 3, 4


def _tables(cls):
    return [cls(f"t{i}", VOCAB, DIM, hotness=HOT,
                combiner="mean" if i % 2 else "sum") for i in range(T)]


def _pdb(root, cls=JPDB):
    """The tables, written by the JAX package's PDB under ``root``."""
    pdb = cls(root)
    for i in range(T):
        pdb.create_table("m", f"t{i}", VOCAB, DIM,
                         initial=_store_rows(VOCAB, DIM, seed=50 + i))
    pdb.flush()
    return pdb


def _port_hps(root, **kw):
    _pdb(root)
    pdb = PersistentDB(root)
    for i in range(T):
        pdb.open_table("m", f"t{i}")
    return HPS("m", _tables(EmbeddingTableConfig), pdb, device="cpu", **kw)


def _queries(n, seed, b=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(-1, VOCAB, size=(b, T, HOT)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("engine", ["lookup", "pipelined", "stream",
                                    "stage_sync"])
def test_striped_hps_matches_jax_and_unstriped(tmp_path, engine):
    """f32 pooled reads of a 3-stripe HPS: bit-exact to the reference's
    3-stripe HPS and to the port's one-stripe HPS (mixed combiners,
    eviction and overflow at capacity 24)."""
    j = JHPS("m", _tables(JTable), _pdb(str(tmp_path / "j")),
             cache_capacity=24, cache_shards=3)
    p = _port_hps(str(tmp_path / "p"), cache_capacity=24, cache_shards=3)
    u = _port_hps(str(tmp_path / "u"), cache_capacity=24)
    qs = _queries(8, seed=23)
    try:
        assert p.caches["t0"].shards == 3
        if engine == "stream":
            want = [np.asarray(w) for w in j.lookup_stream(qs)]
            got = list(p.lookup_stream(qs))
            flat = list(u.lookup_stream(qs))
        else:
            run = {"lookup": lambda h, q: h.lookup(q),
                   "pipelined": lambda h, q: h.lookup(q, pipelined=True),
                   "stage_sync": lambda h, q: h.lookup_stage_sync(q)}[engine]
            want = [np.asarray(run(j, q)) for q in qs]
            got = [run(p, q).numpy() for q in qs]
            flat = [run(u, q).numpy() for q in qs]
        for g, w, f in zip(got, want, flat):
            assert g.shape == (6, T, DIM)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, f)
        if engine != "stream":      # the stream's probe order is timing's
            assert p.stats()["l1_hit_rate"] == j.stats()["l1_hit_rate"]
            assert p.stats()["l3_fetches"] == j.stats()["l3_fetches"]
    finally:
        for h in (j, p, u):
            h.close()


def _publish(mod, bus, versions, seed=31):
    """The same update stream through either package's producer: each
    version rewrites 30 ids of every table."""
    prod = mod.Producer(bus, "m", max_batch_rows=1 << 20)
    rng = np.random.default_rng(seed)
    for v in versions:
        for i in range(T):
            ids = rng.choice(VOCAB, size=30, replace=False)
            prod.send(f"t{i}", ids, rng.normal(size=(30, DIM)).astype(
                np.float32) * (1 + v))
        prod.flush(version=v)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_updates_then_refresh_match_jax(tmp_path, shards, payload_dtype):
    jb, pb = jbus.MessageBus(), pbus.MessageBus()
    j = JHPS("m", _tables(JTable), _pdb(str(tmp_path / "j")),
             cache_capacity=48, cache_shards=shards, bus=jb,
             payload_dtype=payload_dtype)
    p = _port_hps(str(tmp_path / "p"), cache_capacity=48,
                  cache_shards=shards, bus=pb, payload_dtype=payload_dtype,
                  refresh_chunk_rows=9)
    qs = _queries(6, seed=3)
    try:
        for q in qs[:3]:                       # fill the L1s
            np.testing.assert_array_equal(p.lookup(q).numpy(),
                                          np.asarray(j.lookup(q)))
        _publish(jbus, jb, (1, 2))
        _publish(pbus, pb, (1, 2))
        assert p.apply_updates() == j.apply_updates() == 2 * T
        assert p.consumer.last_versions == j.consumer.last_versions == {
            f"t{i}": 2 for i in range(T)}
        assert p.refresh_backlog() == j.refresh_backlog() > 0
        while j.refresh_backlog():
            assert p.refresh_step(7) == j.refresh_step(7)
        assert p.refresh_backlog() == 0
        assert p.stats()["refresh"] == j.stats()["refresh"]
        for t in p.tables:                     # the same L1 bytes
            (pp, ps), (jp, js) = p.caches[t.name].payload, \
                j.caches[t.name].payload
            np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
            if ps is not None:
                np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        for q in qs:
            np.testing.assert_array_equal(p.lookup(q).numpy(),
                                          np.asarray(j.lookup(q)))
        # every resident row now holds the PDB's updated f32 row (int8:
        # requantized from it, within half a step)
        for t in p.tables:
            ids = p.caches[t.name].resident_ids()
            got = p.caches[t.name].query(ids).numpy()
            want = p.pdb.fetch("m", t.name, ids)
            step = np.abs(want).max(axis=1, keepdims=True) / 127.0
            bound = 0.0 if payload_dtype == "f32" else step / 2 + 1e-6
            assert (np.abs(got - want) <= bound).all()
    finally:
        j.close()
        p.close()


def test_hps_refresh_step_and_stats(tmp_path):
    hps = _port_hps(str(tmp_path), cache_capacity=16)
    cat = np.full((1, T, HOT), -1, np.int32)
    cat[0, :, 0] = [1, 2, 3]
    hps.lookup(cat)
    assert hps.schedule_refresh() == T        # one resident row a table
    assert hps.refresh_backlog() == T
    assert hps.refresh_step(budget=8) == T
    st = hps.stats()
    assert st["refresh"] == {"rows_refreshed": T, "chunks": T,
                             "backlog": 0}
    assert sum(st["l3_fetches"]["calls"].values()) >= T
    assert hps.apply_updates() == 0           # no bus: nothing to poll
    assert hps.refresh_caches() == T
    assert hps.resize_caches(8) == T and hps.cache_capacity == 8


def test_update_hammer_never_tears_a_row(tmp_path):
    """``refresh_step`` runs concurrently with ``lookup_stream`` while a
    third thread keeps applying updates, for 2 s: no deadlock, and every
    row read is exactly one published version of exactly the queried id
    (value = id + version * VSTEP across the row), never a torn row nor
    another id's slot; the observed lock order stays acyclic."""
    vocab, dim, tn, vstep = 64, 8, 2, 100000.0
    bus = pbus.MessageBus()
    pdb = PersistentDB(str(tmp_path))
    tabs = []
    for t in range(tn):
        init = np.repeat(np.arange(vocab, dtype=np.float32)[:, None], dim,
                         axis=1)                # version 0: value == id
        pdb.create_table("m", f"t{t}", vocab, dim, initial=init)
        tabs.append(EmbeddingTableConfig(f"t{t}", vocab, dim, hotness=1))
    hps = HPS("m", tabs, pdb, cache_capacity=32, cache_shards=2, bus=bus,
              device="cpu")
    rec = LockOrderRecorder()
    rec.instrument_hps(hps)
    stop = threading.Event()
    failures = []

    def updater():
        try:
            prod = pbus.Producer(bus, "m")
            rng = np.random.default_rng(5)
            v = 0
            while not stop.is_set():
                v = (v % 99) + 1                # values stay f32-exact
                ids = np.unique(rng.integers(0, vocab, size=8))
                rows = np.broadcast_to(
                    ids.astype(np.float32)[:, None] + v * vstep,
                    (len(ids), dim)).copy()
                for t in range(tn):
                    prod.send(f"t{t}", ids, rows)
                prod.flush(version=v)
                hps.apply_updates()
        except Exception as e:                  # pragma: no cover
            failures.append(e)

    def refresher():
        try:
            while not stop.is_set():
                hps.refresh_step(budget=8)
                hps.schedule_refresh()          # keep the backlog alive
        except Exception as e:                  # pragma: no cover
            failures.append(e)

    rng = np.random.default_rng(7)
    qs = []

    def queries(deadline):
        while time.monotonic() < deadline:
            qs.append(rng.integers(0, vocab, size=(6, tn, 1)).astype(
                np.int32))
            yield qs[-1]

    threads = [threading.Thread(target=updater, daemon=True),
               threading.Thread(target=refresher, daemon=True)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    seen = 0
    try:
        for t in threads:
            t.start()
        stream = hps.lookup_stream(queries(time.monotonic() + 2.0))
        for i, out in enumerate(stream):
            q = qs[i]
            for b in range(q.shape[0]):
                for t in range(tn):
                    row = out[b, t]
                    assert np.all(row == row[0]), f"torn row: {row}"
                    assert row[0] % vstep == q[b, t, 0], \
                        f"wrong id's slot: {row[0]} for id {q[b, t, 0]}"
                    assert 0 <= row[0] // vstep <= 99
            seen += 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
        hps.close()
    assert not any(t.is_alive() for t in threads), "deadlocked threads"
    assert not failures, failures
    assert seen > 0 and hps.stats()["refresh"]["rows_refreshed"] > 0
    assert rec.edges(), "the hammer never held two locks at once"
    rec.assert_acyclic()


# ---------------------------------------------------------------------------
# the server drives the refresh
# ---------------------------------------------------------------------------

class _SumModel:
    """A dense net that adds the pooled rows: a row's update shows in the
    prediction."""

    def apply_dense(self, params, dense, emb, wide, extras=None):
        return emb.sum(dim=(1, 2))


@pytest.mark.parametrize("engine", ["stream", "sync"])
def test_server_loop_drives_refresh(tmp_path, engine):
    bus = pbus.MessageBus()
    hps = _port_hps(str(tmp_path), cache_capacity=16, bus=bus)
    server = InferenceServer(_SumModel(), {}, hps, refresh_budget=8,
                             engine=engine)
    cat = np.full((1, T, HOT), -1, np.int32)
    cat[0, :, 0] = [5, 6, 7]
    dense = np.zeros((1, 1), np.float32)
    before = server.predict(dense, cat)
    prod = pbus.Producer(bus, "m")
    prod.send("t0", np.asarray([5]), np.full((1, DIM), 42.0, np.float32))
    prod.flush(version=3)
    assert server.update_versions() == {}
    server.start()
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            c = server.counters()
            if c["updates_applied"] and c["rows_refreshed"]:
                break
            time.sleep(0.02)
        if engine == "stream":      # a request through the stream engine
            out = server.submit(dense, cat).get(timeout=30)
            assert not isinstance(out, Exception), out
    finally:
        server.stop()
    c = server.counters()
    assert c["updates_applied"] >= 1           # the loop polled the bus
    assert c["rows_refreshed"] >= 1            # and drained the dirty row
    assert server.update_versions() == {"t0": 3}
    after = server.predict(dense, cat)
    assert not np.allclose(before, after)      # the update reached serving
    np.testing.assert_array_equal(
        hps.caches["t0"].query(np.asarray([5])).numpy(),
        np.full((1, DIM), 42.0, np.float32))
    server.close()


def test_refresh_poll_sweeps_rows_changed_out_of_band(tmp_path):
    """Without a bus, ``refresh_poll_s`` makes the loop's ticks mark every
    resident row stale, so a row rewritten in L2/L3 out of band reaches
    the L1; the HPS's own refresh threads do the same."""
    hps = _port_hps(str(tmp_path), cache_capacity=16)
    cat = np.full((1, T, HOT), -1, np.int32)
    cat[0, :, 0] = [5, 6, 7]
    hps.lookup(cat)
    new = np.full((1, DIM), 9.0, np.float32)
    for t, v in (("t0", 9.0), ("t1", 11.0)):
        rows = np.full((1, DIM), v, np.float32)
        hps.pdb.upsert("m", t, np.asarray([5 if t == "t0" else 6]), rows)
        hps.vdb.insert(hps._vdb_key(t),
                       np.asarray([5 if t == "t0" else 6]), rows)
    server = InferenceServer(_SumModel(), {}, hps, refresh_poll_s=0.01)
    server.start()
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                server.counters()["rows_refreshed"] < T:
            time.sleep(0.02)
    finally:
        server.stop()
    np.testing.assert_array_equal(
        hps.caches["t0"].query(np.asarray([5])).numpy(), new)
    hps.pdb.upsert("m", "t1", np.asarray([6]), new)
    hps.vdb.insert(hps._vdb_key("t1"), np.asarray([6]), new)
    before = hps.stats()["refresh"]["rows_refreshed"]
    hps.start_refresh(0.01)
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                hps.stats()["refresh"]["rows_refreshed"] < before + T:
            time.sleep(0.02)
    finally:
        hps.stop_refresh()
    np.testing.assert_array_equal(
        hps.caches["t1"].query(np.asarray([6])).numpy(), new)
    server.close()


# ---------------------------------------------------------------------------
# striped bundles with a refresh budget, both ways
# ---------------------------------------------------------------------------

def _requests(cfg, n, b, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, cfg.num_dense_features)).astype(
        np.float32), np.stack([rng.integers(0, t.vocab_size, (b, 1))
                               for t in cfg.tables], axis=1).astype(np.int32))
        for _ in range(n)]


def _bus_updates(mod, bus, cfg, seed=4):
    """Version 1 of three tables' first 20 rows, through ``mod``'s
    producer."""
    prod = mod.Producer(bus, cfg.name, max_batch_rows=1 << 20)
    rng = np.random.default_rng(seed)
    for t in cfg.tables[:3]:
        prod.send(t.name, np.arange(20), rng.normal(
            size=(20, t.dim)).astype(np.float32))
    prod.flush(version=1)


def test_online_update_reaches_server(tmp_path):
    """A deployed DLRM's HPS on a bus: the update lands in the PDB, the L1
    stays stale until refreshed, and ``refresh_caches`` brings it in."""
    cfg = registry.reduce_recsys_for_smoke(registry.dlrm_criteo)
    params = RecsysModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    write_bundle(str(tmp_path), api.dlrm_graph(cfg), params,
                 {t.name: rng.standard_normal((t.vocab_size, t.dim))
                  .astype(np.float32) for t in cfg.tables},
                 cache_capacity=64)
    bus = pbus.MessageBus()
    server, _ = build_server_from_config(str(tmp_path / "ps.json"),
                                         device="cpu", bus=bus)
    hps, t = server.hps, cfg.tables[0]
    cat = np.full((1, len(cfg.tables), 2), -1, np.int32)
    cat[0, 0, 0] = 5
    before = hps.lookup(cat).numpy()[0, 0]
    prod = pbus.Producer(bus, cfg.name)
    prod.send(t.name, np.asarray([5]), np.full((1, t.dim), 1234.5,
                                               np.float32))
    prod.flush()
    assert hps.apply_updates() == 1
    np.testing.assert_array_equal(hps.pdb.fetch(cfg.name, t.name, [5])[0],
                                  np.full(t.dim, 1234.5, np.float32))
    np.testing.assert_array_equal(hps.lookup(cat).numpy()[0, 0], before)
    hps.refresh_caches()
    np.testing.assert_array_equal(hps.lookup(cat).numpy()[0, 0],
                                  np.full(t.dim, 1234.5, np.float32))
    server.close()


def test_port_serves_jax_striped_bundle(tmp_path):
    m = jrecipe.build_model(smoke=True)
    m.compile()
    with m.mesh:
        m._params = m.model.init(jax.random.PRNGKey(0))
    m.deploy(str(tmp_path), cache_capacity=64, cache_shards=2,
             refresh_budget=64)
    ps = str(tmp_path / "ps.json")
    with open(ps) as f:
        d = json.load(f)
    assert (d["cache_shards"], d["refresh_budget"]) == (2, 64)
    jb, pb = jbus.MessageBus(), pbus.MessageBus()
    jserver, _ = jbuild(ps, bus=jb)
    server, _ = build_server_from_config(ps, device="cpu", bus=pb)
    assert server.refresh_budget == 64 and server.hps.cache_shards == 2
    assert all(c.shards == 2 for c in server.hps.caches.values())
    reqs = _requests(m.cfg, 3, 32, seed=11)
    try:
        for dn, c in reqs:
            np.testing.assert_allclose(server.predict(dn, c),
                                       jserver.predict(dn, c),
                                       rtol=PROB_TOL, atol=PROB_TOL)
            np.testing.assert_array_equal(server.hps.lookup(c).numpy(),
                                          np.asarray(jserver.hps.lookup(c)))
        # the same updates on both buses, drained by each server's tick
        _bus_updates(jbus, jb, m.cfg)
        _bus_updates(pbus, pb, m.cfg)
        for s in (server, jserver):
            s._refresh_tick()
            while s.hps.refresh_backlog():
                s._refresh_tick()
        assert server.update_versions() == jserver.update_versions() == {
            t.name: 1 for t in m.cfg.tables[:3]}
        assert server.counters()["rows_refreshed"] == \
            jserver.counters()["rows_refreshed"] > 0
        for dn, c in reqs:
            c = c.copy()
            c[:4, :3, 0] = np.arange(4)[:, None]   # updated ids
            np.testing.assert_array_equal(server.hps.lookup(c).numpy(),
                                          np.asarray(jserver.hps.lookup(c)))
    finally:
        server.close()


def test_jax_serves_port_striped_bundle(tmp_path):
    cfg = registry.reduce_recsys_for_smoke(registry.dlrm_criteo)
    m = api.dlrm_graph(cfg, solver=api.Solver(batch_size=64, lr=1e-2))
    m.compile(device="cpu")
    m.fit(steps=1)
    bus = pbus.MessageBus()
    server = m.deploy(str(tmp_path), cache_capacity=48, cache_shards=2,
                      refresh_budget=64, bus=bus)
    with open(tmp_path / "ps.json") as f:
        d = json.load(f)
    assert (d["cache_shards"], d["refresh_budget"]) == (2, 64)
    assert server.refresh_budget == 64 and server.hps.cache_shards == 2
    jserver, _ = jbuild(str(tmp_path / "ps.json"))
    assert jserver.refresh_budget == 64 and jserver.hps.cache_shards == 2
    reqs = _requests(cfg, 2, 40, seed=8)
    try:
        for dn, c in reqs:
            np.testing.assert_allclose(jserver.predict(dn, c),
                                       server.predict(dn, c),
                                       rtol=PROB_TOL, atol=PROB_TOL)
            np.testing.assert_array_equal(server.hps.lookup(c).numpy(),
                                          np.asarray(jserver.hps.lookup(c)))
        # online: the deploy's bus reaches the port server's loop
        _bus_updates(pbus, bus, cfg)
        server.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                server.update_versions().get(cfg.tables[2].name) != 1
                or server.hps.refresh_backlog()):
            time.sleep(0.02)
        server.stop()
        assert server.update_versions() == {t.name: 1
                                            for t in cfg.tables[:3]}
        ids = np.arange(20)
        pdb = PersistentDB(str(tmp_path / "pdb"))
        pdb.open_table(cfg.name, cfg.tables[0].name)
        np.testing.assert_array_equal(
            server.hps.caches[cfg.tables[0].name].query(ids).numpy(),
            pdb.fetch(cfg.name, cfg.tables[0].name, ids))
    finally:
        server.close()


def test_wide_bundle_applies_every_message_on_each_hps(tmp_path):
    """As in the reference, each HPS's consumer writes EVERY table of its
    model to L2/L3 and marks only its own L1: a wide model's two HPSes
    each apply every message, so ``updates_applied`` counts them twice,
    in both packages, and each L1 serves its own tables' new rows."""
    cfg = registry.reduce_recsys_for_smoke(registry.RECSYS_ARCHS[
        "wdl-criteo"])
    m = api.recipe_graph(cfg, solver=api.Solver(batch_size=64, lr=1e-2))
    m.compile(device="cpu")
    m.fit(steps=1)
    m.deploy(str(tmp_path), cache_capacity=32).close()
    ps = str(tmp_path / "ps.json")
    pb, jb = pbus.MessageBus(), jbus.MessageBus()
    server, _ = build_server_from_config(ps, device="cpu", bus=pb)
    jserver, _ = jbuild(ps, bus=jb)
    deep, wide = cfg.tables[0], f"{cfg.tables[0].name}_wide"
    ids = np.arange(6)
    cat = np.zeros((6, len(cfg.tables), 1), np.int32)
    cat[:, 0, 0] = ids
    try:
        for s in (server, jserver):
            s.hps.lookup(cat)                  # make the rows resident
            s.wide_hps.lookup(cat)
        rng = np.random.default_rng(6)
        rows = {deep.name: rng.normal(size=(6, deep.dim)).astype(
            np.float32), wide: rng.normal(size=(6, 1)).astype(np.float32)}
        for mod, bus in ((pbus, pb), (jbus, jb)):
            prod = mod.Producer(bus, cfg.name)
            for t, r in rows.items():
                prod.send(t, ids, r)
            prod.flush(version=1)
        for s in (server, jserver):
            s._refresh_tick()
        assert server.counters()["updates_applied"] == \
            jserver.counters()["updates_applied"] == 2 * len(rows)
        assert server.counters()["rows_refreshed"] == \
            jserver.counters()["rows_refreshed"] == 12
        np.testing.assert_array_equal(
            server.hps.lookup(cat).numpy()[:, 0], rows[deep.name])
        np.testing.assert_array_equal(
            server.wide_hps.lookup(cat).numpy()[:, 0], rows[wide])
        for a, b in ((server.hps, jserver.hps),
                     (server.wide_hps, jserver.wide_hps)):
            np.testing.assert_array_equal(a.lookup(cat).numpy(),
                                          np.asarray(b.lookup(cat)))
    finally:
        server.close()
