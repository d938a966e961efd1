"""The port's HPS against the JAX package's on the same PDB and query
stream: the PDB format is shared both ways, and ``HPS.lookup`` (sequential
and ``pipelined``) and ``lookup_stream`` give bit-identical pooled
embeddings in f32, f16 and int8, with an L1 small enough to force eviction
and overflow. Also: a scatter issued while a plan is in flight leaves that
plan's result unchanged (clone-on-write snapshots)."""
import pytest

torch = pytest.importorskip("torch")

import threading

import numpy as np

from repro.configs.base import EmbeddingTableConfig as JTable
from repro.core.hps.hps import HPS as JHPS
from repro.core.hps.persistent_db import PersistentDB as JPDB
from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.core.hps.embedding_cache import DeviceEmbeddingCache
from repro_torch.core.hps.hps import HPS
from repro_torch.core.hps.persistent_db import PersistentDB

VOCABS = (300, 50, 1000)
DIM = 8


def _tables(cls, hotness=1):
    return tuple(cls(f"t{i}", v, DIM, hotness=hotness)
                 for i, v in enumerate(VOCABS))


@pytest.fixture(scope="module")
def pdb_root(tmp_path_factory):
    """Tables written by the JAX package's PDB."""
    root = str(tmp_path_factory.mktemp("pdb"))
    pdb = JPDB(root)
    rng = np.random.default_rng(0)
    for t in _tables(JTable):
        pdb.create_table("m", t.name, t.vocab_size, t.dim,
                         initial=rng.standard_normal(
                             (t.vocab_size, t.dim)).astype(np.float32))
    pdb.flush()
    return root


def _stream(n=6, b=48, h=1, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cols = []
        for v in VOCABS:
            u = rng.random((b, h))
            x = (u * ((v + 1.0) ** -0.1 - 1.0) + 1.0) ** (1 / -0.1)
            ids = np.clip(np.floor(x).astype(np.int64) - 1, 0, v - 1)
            ids[rng.random((b, h)) < 0.1] = -1
            cols.append(ids)
        out.append(np.stack(cols, axis=1).astype(np.int32))
    return out


def test_port_reads_jax_pdb_and_back(pdb_root, tmp_path):
    jpdb, pdb = JPDB(pdb_root), PersistentDB(pdb_root)
    ids = np.array([0, 7, 49, 3, 3])
    for t in _tables(JTable):
        jpdb.open_table("m", t.name)
        pdb.open_table("m", t.name)
        assert pdb.table_shape("m", t.name) == (t.vocab_size, DIM)
        np.testing.assert_array_equal(pdb.fetch("m", t.name, ids),
                                      jpdb.fetch("m", t.name, ids))
    # and the JAX package reads a table the port wrote
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)
    PersistentDB(str(tmp_path)).create_table("p", "x", 10, 4, initial=rows)
    back = JPDB(str(tmp_path))
    back.open_table("p", "x")
    np.testing.assert_array_equal(back.fetch("p", "x", np.arange(10)), rows)


def _pair(pdb_root, payload_dtype, capacity, hotness):
    jpdb, pdb = JPDB(pdb_root), PersistentDB(pdb_root)
    for t in _tables(JTable):
        jpdb.open_table("m", t.name)
        pdb.open_table("m", t.name)
    j = JHPS("m", _tables(JTable, hotness), jpdb, cache_capacity=capacity,
             payload_dtype=payload_dtype)
    p = HPS("m", _tables(EmbeddingTableConfig, hotness), pdb,
            cache_capacity=capacity, payload_dtype=payload_dtype,
            device="cpu")
    return j, p


@pytest.mark.parametrize("mode", ["sequential", "pipelined", "stream"])
@pytest.mark.parametrize("payload_dtype", ["f32", "f16", "int8"])
def test_lookup_matches_jax_bit_exact(pdb_root, payload_dtype, mode):
    # capacity 16 < unique ids per batch: eviction AND overflow
    j, p = _pair(pdb_root, payload_dtype, capacity=16, hotness=1)
    cats = _stream()
    # more distinct ids in one table block than L1 rows: overflow happens
    assert max(len(np.unique(c[:, ti][c[:, ti] >= 0]))
               for c in cats for ti in range(len(VOCABS))) > 16
    try:
        if mode == "stream":
            want = list(j.lookup_stream(cats))
            got = list(p.lookup_stream(cats))
        else:
            pipe = mode == "pipelined"
            want = [np.asarray(j.lookup(c, pipelined=pipe)) for c in cats]
            got = [p.lookup(c, pipelined=pipe).numpy() for c in cats]
        assert len(got) == len(want) == len(cats)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        if mode == "stream":
            # At the adaptive depth (>= 2) both packages submit the probes
            # of consecutive queries to one two-worker pool, so two probes
            # of the same table may take its cache lock in either order:
            # evictions, and with them the hit and fetch counts, follow
            # thread timing (the values cannot, every row comes from the
            # one PDB). One query in flight orders the probes on both
            # sides, so the stats are compared there, on fresh caches.
            j.close()
            p.close()
            j, p = _pair(pdb_root, payload_dtype, capacity=16, hotness=1)
            for g, w in zip(p.lookup_stream(cats, depth=1),
                            j.lookup_stream(cats, depth=1)):
                np.testing.assert_array_equal(g, np.asarray(w))
        js, ps = j.stats(), p.stats()
        assert ps["l1_hit_rate"] == js["l1_hit_rate"]
        assert ps["l3_fetches"] == js["l3_fetches"]
        assert ps["l2_hits"] == js["l2_hits"]
    finally:
        j.close()
        p.close()


@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_multi_hot_lookup_matches_jax(pdb_root, payload_dtype):
    """H=3 sums three rows per table: the sum order may differ, <= 1e-6."""
    j, p = _pair(pdb_root, payload_dtype, capacity=64, hotness=3)
    try:
        for c in _stream(n=4, b=20, h=3, seed=7):
            np.testing.assert_allclose(p.lookup(c).numpy(),
                                       np.asarray(j.lookup(c)),
                                       rtol=1e-6, atol=1e-6)
    finally:
        j.close()
        p.close()


def test_cache_query_matches_jax(pdb_root):
    j, p = _pair(pdb_root, "f32", capacity=16, hotness=1)
    ids = np.array([5, 5, -1, 200, 9, 17, 250, 3, 1, 0, 299, 42] * 3)
    jc, pc = j.caches["t0"], p.caches["t0"]
    for k in range(3):
        q = np.where(ids >= 0, (ids + 37 * k) % VOCABS[0], -1)
        np.testing.assert_array_equal(pc.query(q).numpy(),
                                      np.asarray(jc.query(q)))


def test_scatter_in_flight_leaves_plan_unchanged():
    store = np.random.default_rng(3).standard_normal((64, 4)).astype(
        np.float32)
    cache = DeviceEmbeddingCache(4, 4, fetch_fn=lambda ids: store[ids],
                                 device="cpu")
    cache.acquire_slots(np.array([0, 1, 2, 3]))        # fill the L1
    plan = cache.probe(np.array([0, 1]))               # all hits: bound now
    snap = plan.payload
    slots = torch.from_numpy(plan.slots.astype(np.int32))
    before = cache._store.gather(snap, slots).clone()
    # a later query evicts every slot and scatters new rows into them
    later = cache.probe(np.array([10, 11, 12, 13]))
    cache.commit(later)
    assert set(later.slots.tolist()) == {0, 1, 2, 3}
    after = cache._store.gather(snap, slots)
    np.testing.assert_array_equal(after.numpy(), before.numpy())
    np.testing.assert_array_equal(after.numpy(), store[[0, 1]])
    # while the live payload now holds the new rows at those slots
    live = cache._store.gather(cache.payload, slots).numpy()
    assert not np.array_equal(live, store[[0, 1]])


def test_concurrent_scatters_never_tear_a_snapshot():
    """Readers gather from their bound snapshots while another thread
    keeps evicting and scattering; every read must match the store."""
    import sys
    store = np.random.default_rng(4).standard_normal((500, 8)).astype(
        np.float32)
    cache = DeviceEmbeddingCache(32, 8, fetch_fn=lambda ids: store[ids],
                                 device="cpu")
    stop = threading.Event()
    errors = []

    def writer():
        rng = np.random.default_rng(5)
        while not stop.is_set():
            cache.acquire_slots(rng.integers(0, 500, 40))

    def reader(seed):
        rng = np.random.default_rng(seed)
        for _ in range(150):
            ids = rng.integers(0, 500, 24)
            slots, ov_idx, ov_rows, snap = cache.acquire_slots(ids)
            out = cache._store.gather(
                snap, torch.from_numpy(slots.astype(np.int32))).numpy()
            out[ov_idx] = ov_rows
            if not np.array_equal(out, store[ids]):
                errors.append(seed)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        w = threading.Thread(target=writer)
        rs = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
        w.start()
        for r in rs:
            r.start()
        for r in rs:
            r.join(timeout=120)
        stop.set()
        w.join(timeout=120)
        assert not w.is_alive() and not any(r.is_alive() for r in rs)
    finally:
        sys.setswitchinterval(old)
    assert not errors
