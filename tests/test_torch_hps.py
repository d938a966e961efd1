"""The port's HPS against the JAX package's on the same PDB and query
stream: the PDB format is shared both ways, and ``HPS.lookup`` (sequential
and ``pipelined``) and ``lookup_stream`` give bit-identical pooled
embeddings in f32, f16 and int8, with an L1 small enough to force eviction
and overflow. One exception, by design in both packages: at
``lookup_stream``'s adaptive depth the lossy payloads' values follow
thread timing (an overflowing row is served as the exact f32 row, an L1
row rounded, and which rows overflow follows the probe order), so there
f16 and int8 are held within their rounding bound of the f32 PDB rows;
f32 stays bit-exact at every depth, and all three payloads are bit-exact
at ``depth=1``. Also: a scatter issued while a plan is in flight leaves
that plan's result unchanged (clone-on-write snapshots); and the pooled
read of all tables (``_pooled_stack``, one grouped read) matches the
reference's with holes, H_t of 1 and 3, the mean combiner, with and
without the mean applied (bit-exact on the H = 1 tables, <= 1e-6 on the
others).

The ``cuda`` cases run the striped L1 on the card: a striped HPS's
pooled read is one K1 (f32) or K6 (int8) launch and its cache query one
K5 / K6 launch, each bit-exact to the unstriped HPS on the card and to
the plain versions on the CPU; after an update, ``refresh_step`` on the
card leaves the L1 reading the PDB's new rows (f32 bit-exact, int8
within half a quantization step)."""
import pytest

torch = pytest.importorskip("torch")

import sys
import threading
import types

import numpy as np

from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.core.hps.embedding_cache import DeviceEmbeddingCache
from repro_torch.core.hps.hps import HPS, _pooled_stack
from repro_torch.core.hps.payload_store import quantize_rows
from repro_torch.core.hps.persistent_db import PersistentDB

VOCABS = (300, 50, 1000)
DIM = 8


def _tables(cls, hotness=1):
    return tuple(cls(f"t{i}", v, DIM, hotness=hotness)
                 for i, v in enumerate(VOCABS))


@pytest.fixture(scope="module")
def J():
    """The JAX reference (imported here, not at module level, so the
    ``cuda`` cases below also run where only torch is installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import EmbeddingTableConfig as JTable
    from repro.core.hps.hps import HPS as JHPS
    from repro.core.hps.hps import _pooled_stack as j_pooled_stack
    from repro.core.hps.persistent_db import PersistentDB as JPDB
    return types.SimpleNamespace(jnp=jnp, Table=JTable, HPS=JHPS,
                                 pooled_stack=j_pooled_stack, PDB=JPDB)


@pytest.fixture(scope="module")
def pdb_root(tmp_path_factory, J):
    """Tables written by the JAX package's PDB."""
    root = str(tmp_path_factory.mktemp("pdb"))
    pdb = J.PDB(root)
    rng = np.random.default_rng(0)
    for t in _tables(J.Table):
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


def test_port_reads_jax_pdb_and_back(J, pdb_root, tmp_path):
    jpdb, pdb = J.PDB(pdb_root), PersistentDB(pdb_root)
    ids = np.array([0, 7, 49, 3, 3])
    for t in _tables(J.Table):
        jpdb.open_table("m", t.name)
        pdb.open_table("m", t.name)
        assert pdb.table_shape("m", t.name) == (t.vocab_size, DIM)
        np.testing.assert_array_equal(pdb.fetch("m", t.name, ids),
                                      jpdb.fetch("m", t.name, ids))
    # and the JAX package reads a table the port wrote
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)
    PersistentDB(str(tmp_path)).create_table("p", "x", 10, 4, initial=rows)
    back = J.PDB(str(tmp_path))
    back.open_table("p", "x")
    np.testing.assert_array_equal(back.fetch("p", "x", np.arange(10)), rows)


def _rounding_bound(J, pdb_root, cat, payload_dtype):
    """The exact pooled rows of one-hot ``cat [B, T, 1]`` from the PDB (f32;
    a -1 id pools to zero) and, elementwise, how far an L1 read of the
    ``payload_dtype`` payload may lie from them: half an f16 ulp of each
    value, or half an int8 step (``max|row| / 127 / 2``) of each row; 0 for
    f32."""
    pdb = J.PDB(pdb_root)
    exact = []
    for ti, t in enumerate(_tables(J.Table)):
        pdb.open_table("m", t.name)
        ids = cat[:, ti, 0]
        rows = pdb.fetch("m", t.name, np.maximum(ids, 0)).astype(np.float32)
        exact.append(np.where(ids[:, None] >= 0, rows, 0.0))
    exact = np.stack(exact, axis=1)
    if payload_dtype == "f16":
        half = np.abs(exact).astype(np.float16)
        bound = np.spacing(half).astype(np.float32) / 2
    elif payload_dtype == "int8":
        step = np.abs(exact).max(axis=-1, keepdims=True) / 127.0
        bound = np.broadcast_to(step / 2 * (1 + 1e-5), exact.shape)
    else:
        bound = np.zeros_like(exact)
    return exact, bound


def _pair(J, pdb_root, payload_dtype, capacity, hotness):
    jpdb, pdb = J.PDB(pdb_root), PersistentDB(pdb_root)
    for t in _tables(J.Table):
        jpdb.open_table("m", t.name)
        pdb.open_table("m", t.name)
    j = J.HPS("m", _tables(J.Table, hotness), jpdb, cache_capacity=capacity,
             payload_dtype=payload_dtype)
    p = HPS("m", _tables(EmbeddingTableConfig, hotness), pdb,
            cache_capacity=capacity, payload_dtype=payload_dtype,
            device="cpu")
    return j, p


@pytest.mark.parametrize("mode", ["sequential", "pipelined", "stream"])
@pytest.mark.parametrize("payload_dtype", ["f32", "f16", "int8"])
def test_lookup_matches_jax_bit_exact(J, pdb_root, payload_dtype, mode):
    # capacity 16 < unique ids per batch: eviction AND overflow
    j, p = _pair(J, pdb_root, payload_dtype, capacity=16, hotness=1)
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
        for c, g, w in zip(cats, got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            if mode != "stream" or payload_dtype == "f32":
                np.testing.assert_array_equal(g, w)
                continue
            # lossy payloads at the adaptive depth: both packages within
            # the payload's rounding bound of the f32 rows
            exact, bound = _rounding_bound(J, pdb_root, c, payload_dtype)
            assert (np.abs(g - exact) <= bound).all()
            assert (np.abs(np.asarray(w) - exact) <= bound).all()
        if mode == "stream":
            # At the adaptive depth (>= 2) both packages submit the probes
            # of consecutive queries to one two-worker pool, so two probes
            # of the same table may take its cache lock in either order:
            # evictions, and with them the hit and fetch counts, follow
            # thread timing, and so do the values of a lossy payload. One
            # query in flight orders the probes on both sides, so values
            # of every payload and the stats are compared bit-exact there,
            # on fresh caches.
            j.close()
            p.close()
            j, p = _pair(J, pdb_root, payload_dtype, capacity=16, hotness=1)
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
def test_multi_hot_lookup_matches_jax(J, pdb_root, payload_dtype):
    """H=3 sums three rows per table: the sum order may differ, <= 1e-6."""
    j, p = _pair(J, pdb_root, payload_dtype, capacity=64, hotness=3)
    try:
        for c in _stream(n=4, b=20, h=3, seed=7):
            np.testing.assert_allclose(p.lookup(c).numpy(),
                                       np.asarray(j.lookup(c)),
                                       rtol=1e-6, atol=1e-6)
    finally:
        j.close()
        p.close()


@pytest.mark.parametrize("payload_dtype", ["f32", "f16", "int8"])
@pytest.mark.parametrize("d", [1, DIM])
@pytest.mark.parametrize("apply_mean", [True, False])
def test_pooled_stack_matches_jax(J, payload_dtype, d, apply_mean):
    rng = np.random.default_rng(d)
    hots = (1, 3, 1, 3)
    combiners = ("sum", "mean", "mean", "sum")
    pays, slots = [], []
    for h in hots:
        rows = rng.standard_normal((20, d)).astype(np.float32)
        pays.append(quantize_rows(rows, payload_dtype))
        s = rng.integers(-1, 20, size=(16, h)).astype(np.int32)
        s[0] = -1                                       # a row of holes
        slots.append(s)
    want = np.asarray(J.pooled_stack(
        tuple((J.jnp.asarray(p), None if sc is None else J.jnp.asarray(sc))
              for p, sc in pays),
        tuple(J.jnp.asarray(s) for s in slots), combiners, apply_mean))
    got = _pooled_stack(
        [(torch.from_numpy(p), None if sc is None else torch.from_numpy(sc))
         for p, sc in pays],
        [torch.from_numpy(s) for s in slots], combiners, apply_mean).numpy()
    assert got.shape == want.shape == (16, len(hots), d)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for t, h in enumerate(hots):
        if h == 1:
            np.testing.assert_array_equal(got[:, t], want[:, t])


def test_cache_query_matches_jax(J, pdb_root):
    j, p = _pair(J, pdb_root, "f32", capacity=16, hotness=1)
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


# ---------------------------------------------------------------------------
# the L1 miss path: the index kept by a merge, the batch staged in one copy
# ---------------------------------------------------------------------------

def _miss_heavy(n=12, b=40, vocab=400, seed=7):
    """Batches of Zipf-skewed ids over a vocabulary >> the L1, ~10% pads:
    every batch misses, evicts and (at capacity 16) overflows."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ids = (rng.zipf(1.3, b) + 37 * k) % vocab
        ids[rng.random(b) < 0.1] = -1
        out.append(ids.astype(np.int64))
    return out


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_incremental_index_and_slots_match_jax(J, payload_dtype, shards):
    """After every probe of a miss-heavy stream the sorted index equals a
    full rebuild's, and the slots, overflow, LFU counters, residents and
    payload bytes equal the JAX cache's bit for bit. Every other plan
    commits through the staged path (its scatter shipped with
    ``to_device_many``, as the HPS device stage ships a batch)."""
    from repro.core.hps.embedding_cache import DeviceEmbeddingCache as JC
    from repro_torch import device as devmod
    store = np.random.default_rng(8).standard_normal((400, DIM)).astype(
        np.float32)
    jc = JC(16, DIM, fetch_fn=lambda ids: store[ids], shards=shards,
            payload_dtype=payload_dtype)
    pc = DeviceEmbeddingCache(16, DIM, fetch_fn=lambda ids: store[ids],
                              shards=shards, payload_dtype=payload_dtype,
                              device="cpu")
    overflowed = 0
    for k, ids in enumerate(_miss_heavy()):
        jp, pp = jc.probe(ids), pc.probe(ids)
        overflowed += len(pp.ov_idx)
        occ = pc._id_of[:pc._next_free]
        order = np.argsort(occ, kind="stable")
        np.testing.assert_array_equal(pc._sorted_ids, occ[order])
        np.testing.assert_array_equal(pc._sorted_slots, order)
        np.testing.assert_array_equal(pp.slots, jp.slots)
        np.testing.assert_array_equal(pp.ov_idx, jp.ov_idx)
        np.testing.assert_array_equal(pp.ov_rows, jp.ov_rows)
        np.testing.assert_array_equal(pc._id_of, jc._id_of)
        np.testing.assert_array_equal(pc._freq, jc._freq)
        np.testing.assert_array_equal(pc._sorted_ids, jc._sorted_ids)
        np.testing.assert_array_equal(pc._sorted_slots, jc._sorted_slots)
        staged = None
        if k % 2 and pp.scatter is not None:
            staged = devmod.to_device_many(pp.scatter, torch.device("cpu"))
        payload, scales = pc.commit(pp, staged)
        jpay, jscales = jc.commit(jp)
        np.testing.assert_array_equal(payload.numpy(), np.asarray(jpay))
        if payload_dtype == "int8":
            np.testing.assert_array_equal(scales.numpy(),
                                          np.asarray(jscales))
    assert pc.misses == jc.misses and pc.hits == jc.hits
    assert overflowed and pc.misses > 5 * pc.hits


def test_staged_scatter_flushed_by_another_probe_is_not_written_twice():
    """A later probe leaves a plan's deferred scatter queued; the later
    probe's commit writes the queue in probe order, binding the plan's
    snapshot after its own scatter, and the plan's staged copy is then
    ignored at its commit."""
    from repro_torch import device as devmod
    store = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    cache = DeviceEmbeddingCache(4, 4, fetch_fn=lambda ids: store[ids],
                                 device="cpu")
    plan = cache.probe(np.array([0, 1]))
    staged = devmod.to_device_many(plan.scatter, torch.device("cpu"))
    later = cache.probe(np.array([5, 6]))      # queued behind plan
    assert plan.payload is None and later.payload is None
    cache.commit(later)                        # flushes plan's scatter
    snap = plan.payload
    assert snap is not None
    assert cache.commit(plan, staged) is snap
    rows = cache._store.gather(snap, torch.tensor(plan.slots, dtype=torch.int32))
    np.testing.assert_array_equal(rows.numpy(), store[[0, 1]])


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_probes_ahead_of_commits_match_jax(J, payload_dtype, shards):
    """Each query probed before the one ahead of it commits (as the
    stream engine's host workers run ahead of its device stage): the
    slots and every plan's snapshot equal the JAX cache's, probed and
    committed in turn, bit for bit; the scatters queue, and no probe
    writes the payload."""
    from repro.core.hps.embedding_cache import DeviceEmbeddingCache as JC
    from repro_torch import device as devmod
    store = np.random.default_rng(9).standard_normal((400, DIM)).astype(
        np.float32)
    jc = JC(16, DIM, fetch_fn=lambda ids: store[ids], shards=shards,
            payload_dtype=payload_dtype)
    pc = DeviceEmbeddingCache(16, DIM, fetch_fn=lambda ids: store[ids],
                              shards=shards, payload_dtype=payload_dtype,
                              device="cpu")
    stream = _miss_heavy(seed=11)
    want = []
    for ids in stream:
        jp = jc.probe(ids)
        want.append((jp.slots, jc.commit(jp)))
    plans = [pc.probe(stream[0])]
    for k, ids in enumerate(stream):
        if k + 1 < len(stream):
            before = pc._store.snapshot()[0]
            plans.append(pc.probe(stream[k + 1]))   # runs ahead
            assert pc._store.snapshot()[0] is before
        plan = plans[k]
        staged = (devmod.to_device_many(plan.scatter, torch.device("cpu"))
                  if k % 2 and plan.scatter is not None else None)
        payload, scales = pc.commit(plan, staged)
        jslots, (jpay, jscales) = want[k]
        np.testing.assert_array_equal(plan.slots, jslots)
        np.testing.assert_array_equal(payload.numpy(), np.asarray(jpay))
        if payload_dtype == "int8":
            np.testing.assert_array_equal(scales.numpy(),
                                          np.asarray(jscales))
    assert not pc._pending


# ---------------------------------------------------------------------------
# the host indexes as hash maps: the L1's and each L2 shard's decisions
# ---------------------------------------------------------------------------

def _turnover(n=50, b=128, vocab=6000, seed=13):
    """Zipf batches over a vocabulary >> an L1 of a few hundred rows, the
    hot set sliding each batch, ~5% pads: the cache fills within a few
    batches, then every batch evicts, and the residents turn over several
    times."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ids = (rng.zipf(1.2, b) + 101 * k) % vocab
        ids[rng.random(b) < 0.05] = -1
        out.append(ids.astype(np.int64))
    return out


@pytest.mark.parametrize("capacity", [200, 500])
def test_index_map_matches_a_rebuild_and_jax(J, capacity):
    """The L1 index is a hash map with no merge step; through a stream
    that fills the cache and then turns its residents over several
    times, after each probe the map's search over every id seen (pads
    included) equals a search of the index rebuilt from the slots, and
    the slots, the LFU counters, the residents and ``resident_ids()``
    equal the JAX cache's bit for bit."""
    from repro.core.hps.embedding_cache import DeviceEmbeddingCache as JC
    store = np.random.default_rng(14).standard_normal((6000, DIM)).astype(
        np.float32)
    jc = JC(capacity, DIM, fetch_fn=lambda ids: store[ids])
    pc = DeviceEmbeddingCache(capacity, DIM, fetch_fn=lambda ids: store[ids],
                              device="cpu")
    seen = np.empty(0, np.int64)
    full_probes = 0
    for ids in _turnover():
        full_probes += pc._next_free == capacity
        jp, pp = jc.probe(ids), pc.probe(ids)
        jc.commit(jp)
        pc.commit(pp)
        seen = np.union1d(seen, ids)
        occ = pc._id_of[:pc._next_free]
        order = np.argsort(occ, kind="stable")
        pos = np.minimum(np.searchsorted(occ[order], seen), len(occ) - 1)
        want = np.where(occ[order][pos] == seen, order[pos], -1)
        with pc._lock:
            np.testing.assert_array_equal(pc._find_locked(seen), want)
        np.testing.assert_array_equal(pp.slots, jp.slots)
        np.testing.assert_array_equal(pp.ov_idx, jp.ov_idx)
        np.testing.assert_array_equal(pc._freq, jc._freq)
        np.testing.assert_array_equal(pc._id_of, jc._id_of)
        np.testing.assert_array_equal(pc.resident_ids(), jc.resident_ids())
    assert full_probes >= 20 and len(seen) > 4 * capacity
    assert pc.hits == jc.hits and pc.misses == jc.misses


def _l2_shards(db, table):
    """A store's shards of ``table``: the port's namespace or the
    reference's list."""
    ns = getattr(db, "_spaces", None)
    return ns[table]._shards if ns is not None else db._store[table]


@pytest.mark.parametrize("shards", [1, 3])
def test_volatile_db_matches_jax(J, shards):
    """Three namespaces in one store, a stream of inserts (ids repeated in
    a batch: the last row wins), queries and explicit evictions that
    overflows every shard's capacity: the found masks and rows, and after
    every call each shard's sorted (id, slot) view, slot contents and
    rows equal the reference ``VolatileDB``'s, so the LRU victims do."""
    from repro.core.hps.volatile_db import VolatileDB as JV
    from repro_torch.core.hps.volatile_db import VolatileDB
    jv = JV(shards=shards, capacity_per_shard=40)
    pv = VolatileDB(shards=shards, capacity_per_shard=40)
    spaces = ("m/a", "m/b", "n/a")
    rng = np.random.default_rng(21)
    evicted = 0
    for step in range(90):
        t = spaces[rng.integers(len(spaces))]
        ids = rng.integers(0, 300, rng.integers(1, 40))
        op = rng.random()
        if op < 0.5:
            rows = rng.standard_normal((len(ids), DIM)).astype(np.float32)
            full = sum(s.n == s.capacity for s in _l2_shards(pv, t)) \
                if t in pv._spaces else 0
            jv.insert(t, ids, rows)
            pv.insert(t, ids, rows)
            evicted += full
        elif op < 0.9:
            jm, jr = jv.query(t, ids)
            pm, pr = pv.query(t, ids)
            np.testing.assert_array_equal(pm, jm)
            assert (pr is None) == (jr is None)
            if pr is not None:
                np.testing.assert_array_equal(pr[pm], jr[jm])
        else:
            jv.evict(t, ids[:5])
            pv.evict(t, ids[:5])
        for t2 in spaces:
            if t2 not in jv._store:
                continue
            for js, ps in zip(_l2_shards(jv, t2), _l2_shards(pv, t2)):
                assert ps.n == js.n
                np.testing.assert_array_equal(ps.sorted_ids, js.sorted_ids)
                np.testing.assert_array_equal(ps.sorted_slots,
                                              js.sorted_slots)
                np.testing.assert_array_equal(ps.id_of, js.id_of)
                assert (ps.rows is None) == (js.rows is None)
                if ps.rows is not None:
                    np.testing.assert_array_equal(ps.rows[:ps.n],
                                                  js.rows[:js.n])
    assert evicted > 5
    assert pv.stats()["hits"] == jv.stats()["hits"]
    assert pv.stats()["misses"] == jv.stats()["misses"]
    assert pv.stats()["tables"] == jv.stats()["tables"]


def test_namespaces_insert_from_four_threads_as_serially():
    """A lock and a clock a namespace: four threads inserting into and
    querying four namespaces of one store at once leave each namespace
    (slots, ids, rows and LRU ticks) and the hit / miss counts as a
    serial run of the same calls does."""
    from repro_torch.core.hps.volatile_db import VolatileDB

    def calls(k):
        rng = np.random.default_rng(100 + k)
        out = []
        for _ in range(40):
            ids = rng.integers(0, 200, rng.integers(1, 30))
            out.append((ids, rng.standard_normal((len(ids), DIM)).astype(
                np.float32)))
        return out

    def run(db, k):
        for ids, rows in calls(k):
            db.insert(f"t{k}", ids, rows)
            db.query(f"t{k}", ids[::2])

    serial = VolatileDB(shards=2, capacity_per_shard=30)
    for k in range(4):
        run(serial, k)
    par = VolatileDB(shards=2, capacity_per_shard=30)
    errors = []
    start = threading.Barrier(4)

    def worker(k):
        try:
            start.wait()
            run(par, k)
        except Exception as e:      # pragma: no cover
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in ts)
    for k in range(4):
        for a, b in zip(_l2_shards(serial, f"t{k}"),
                        _l2_shards(par, f"t{k}")):
            assert a.n == b.n
            np.testing.assert_array_equal(a.id_of, b.id_of)
            np.testing.assert_array_equal(a.tick, b.tick)
            np.testing.assert_array_equal(a.rows, b.rows)
            np.testing.assert_array_equal(a.sorted_slots, b.sorted_slots)
    assert par.stats() == serial.stats()


def test_lock_order_recorder_sees_namespace_locks(tmp_path):
    """The dynamic lock-order check wraps each L2 namespace's lock, those
    made after it was armed included: a pipelined lookup records the L1
    lock -> namespace lock edges, and the graph stays acyclic."""
    from repro_torch.analysis import LockOrderRecorder
    pdb = PersistentDB(str(tmp_path))
    rng = np.random.default_rng(3)
    tabs = _tables(EmbeddingTableConfig)
    for t in tabs:
        pdb.create_table("m", t.name, t.vocab_size, t.dim,
                         initial=rng.standard_normal(
                             (t.vocab_size, t.dim)).astype(np.float32))
    hps = HPS("m", tabs, pdb, cache_capacity=16, device="cpu")
    rec = LockOrderRecorder()
    rec.instrument_hps(hps)
    try:
        for cat in _stream(n=3):
            hps.lookup(cat, pipelined=True)
    finally:
        hps.close()
    for t in tabs:
        assert (f"cache[{t.name}]._lock",
                f"VolatileDB[m/{t.name}]._lock") in rec.edges()
    rec.assert_acyclic()


def test_id_index_find_update_and_sorted_view():
    """``IdIndex``: any ids searched (repeats, absent ids, pads -> -1),
    updates that unmap and map in one call, and the sorted view."""
    from repro_torch.core.hps.id_index import IdIndex
    idx = IdIndex(np.array([7, 3, 11], np.int64), np.array([0, 1, 2]))
    np.testing.assert_array_equal(
        idx.find(np.array([3, -1, 7, 3, 5])), [1, -1, 0, 1, -1])
    idx.update(np.array([7]), np.array([9, 2]), np.array([0, 3]))
    assert len(idx) == 4
    ids, slots = idx.sorted_view()
    np.testing.assert_array_equal(ids, [2, 3, 9, 11])
    np.testing.assert_array_equal(slots, [3, 1, 0, 2])
    assert idx.find(np.array([7])).tolist() == [-1]
    empty = IdIndex()
    assert empty.find(np.zeros(0, np.int64)).shape == (0,)
    assert [a.tolist() for a in empty.sorted_view()] == [[], []]


# ---------------------------------------------------------------------------
# the host library: its map, the probe's passes, the L2 and L3 calls
# ---------------------------------------------------------------------------

_U64 = (1 << 64) - 1


def _mix(key: int) -> int:
    """The host map's hash (splitmix64's finaliser) of an int64 key."""
    x = ((key & _U64) + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


def _map_keys(case: str, rng) -> np.ndarray:
    """The key pool of a map stream: wide random ids; ids whose home cell
    agrees in its low 10 bits (one cluster at every table size up to
    1,024 cells, so deletes shift it); or ids at both ends of int64 and
    around 0."""
    if case == "random":
        return rng.integers(-(1 << 40), 1 << 40, 3000)
    if case == "collisions":
        out, k = [], 0
        while len(out) < 60:
            if _mix(k) & 1023 == 5:
                out.append(k)
            k += 1
        return np.array(out, np.int64)
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    return np.array(sorted({*range(lo, lo + 40), *range(hi - 40, hi + 1),
                            *range(-40, 40)}), np.int64)


@pytest.mark.parametrize("case", ["random", "collisions", "extremes"])
def test_host_map_matches_a_dict_and_a_sorted_rebuild(case):
    """The host library's id -> slot map (``IdIndex``) against a ``dict``
    over a seeded stream of updates (unmapping residents, mapping new ids)
    and searches (residents, absent ids, repeats): every search, the
    size, and the sorted view against the dict's sorted items, through
    growth from empty to thousands of ids and back down; an unmapped id
    among ``gone`` raises ``KeyError``, a negative slot ``ValueError``."""
    from repro_torch.core.hps.id_index import IdIndex
    rng = np.random.default_rng({"random": 1, "collisions": 2,
                                 "extremes": 3}[case])
    pool = _map_keys(case, rng)
    idx, ref = IdIndex(), {}
    next_slot = 0
    for step in range(300):
        grow = step < 150
        absent = np.array([k for k in rng.choice(pool, 40) if k not in ref],
                          np.int64)
        new = np.unique(absent)[:int(rng.integers(0, 40 if grow else 8))]
        present = np.array(list(ref), np.int64)
        n_gone = int(rng.integers(0, 6 if grow else 40))
        gone = (rng.choice(present, min(n_gone, len(present)),
                           replace=False) if len(present) else present)
        slots = np.arange(next_slot, next_slot + len(new), dtype=np.int64)
        next_slot += len(new)
        idx.update(gone, new, slots)
        for g in gone.tolist():
            del ref[g]
        ref.update(zip(new.tolist(), slots.tolist()))
        probe = np.concatenate([rng.choice(pool, 30), present[:10],
                                present[:3]]).astype(np.int64)
        np.testing.assert_array_equal(
            idx.find(probe), [ref.get(k, -1) for k in probe.tolist()])
        assert len(idx) == len(ref)
        if step % 25 == 0 or step == 299:
            ids, sl = idx.sorted_view()
            want = sorted(ref.items())
            np.testing.assert_array_equal(ids, [k for k, _ in want])
            np.testing.assert_array_equal(sl, [v for _, v in want])
            rebuilt = IdIndex(ids, sl)
            np.testing.assert_array_equal(rebuilt.find(pool), idx.find(pool))
    assert next_slot > len(pool) // 4 or case == "extremes"
    absent = next(k for k in pool.tolist() if k not in ref)
    with pytest.raises(KeyError):
        idx.update(np.array([absent]), np.zeros(0, np.int64),
                   np.zeros(0, np.int64))
    with pytest.raises(ValueError):
        idx.update(np.zeros(0, np.int64), np.array([absent]),
                   np.array([-3]))


def _l2_state(vdb, table):
    """Each shard of ``table``: occupancy, ids, ticks, rows, sorted view."""
    return [(sh.n, sh.id_of.copy(), sh.tick.copy(),
             None if sh.rows is None else sh.rows[:sh.n].copy(),
             sh.sorted_ids, sh.sorted_slots)
            for sh in _l2_shards(vdb, table)]


def _probe_stream(seed=17):
    """Batches over a vocabulary of 1,000 with the hot set sliding: pads
    (-1 and other negatives), repeats, one all-pad block, one batch of 200
    distinct ids (past the L1 of 40: the overflow path), the rest
    Zipf-skewed."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(30):
        if k == 7:
            out.append(np.full(48, -1, np.int64))
            continue
        if k == 12:
            out.append(rng.permutation(1000)[:200].astype(np.int64))
            continue
        ids = (rng.zipf(1.2, 64) + 29 * k) % 1000
        ids[rng.random(64) < 0.1] = -1
        ids[rng.random(64) < 0.03] = -7
        out.append(ids.astype(np.int64))
    return out


@pytest.mark.parametrize("l2_shards", [1, 2])
def test_probe_passes_match_jax_with_l1_and_l2_evicting(J, tmp_path,
                                                         l2_shards):
    """One table's L1 probe (its two host passes) through an L2 small
    enough to evict and the L3, against the JAX package's HPS on the same
    PDB and stream: after every probe the slots, the overflow positions
    and rows, the hit / miss counts, the LFU counters and the residents,
    each L2 shard's ids, ticks, rows and sorted index, and the rows the
    PDB returned, all bit for bit; the stream evicts in both levels and
    overflows the L1."""
    from repro.core.hps.volatile_db import VolatileDB as JV
    from repro_torch.core.hps.volatile_db import VolatileDB
    rng = np.random.default_rng(5)
    root = str(tmp_path)
    J.PDB(root).create_table("m", "t", 1000, DIM, initial=rng.standard_normal(
        (1000, DIM)).astype(np.float32))
    jpdb, pdb = J.PDB(root), PersistentDB(root)
    jpdb.open_table("m", "t")
    pdb.open_table("m", "t")
    seen = {"j": [], "p": []}

    def spy(db, key):
        fetch = db.fetch

        def run(model, table, ids):
            rows = fetch(model, table, ids)
            seen[key].append((np.array(ids), np.array(rows)))
            return rows
        db.fetch = run

    spy(jpdb, "j")
    spy(pdb, "p")
    j = J.HPS("m", (J.Table("t", 1000, DIM),), jpdb, cache_capacity=40,
              vdb=JV(shards=l2_shards, capacity_per_shard=60))
    p = HPS("m", (EmbeddingTableConfig("t", 1000, DIM),), pdb,
            cache_capacity=40, device="cpu",
            vdb=VolatileDB(shards=l2_shards, capacity_per_shard=60))
    jc, pc = j.caches["t"], p.caches["t"]
    overflowed = l2_full = 0
    for ids in _probe_stream():
        jp, pp = jc.probe(ids), pc.probe(ids)
        jc.commit(jp)
        pc.commit(pp)
        overflowed += len(pp.ov_idx)
        np.testing.assert_array_equal(pp.slots, jp.slots)
        np.testing.assert_array_equal(pp.ov_idx, jp.ov_idx)
        np.testing.assert_array_equal(pp.ov_rows, jp.ov_rows)
        assert (pc.hits, pc.misses) == (jc.hits, jc.misses)
        np.testing.assert_array_equal(pc._freq, jc._freq)
        np.testing.assert_array_equal(pc._id_of, jc._id_of)
        np.testing.assert_array_equal(pc.resident_ids(), jc.resident_ids())
        for a, b in zip(_l2_state(p.vdb, "m/t"), _l2_state(j.vdb, "m/t")):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                np.testing.assert_array_equal(x, y)
        l2_full += any(s.n == s.capacity for s in _l2_shards(p.vdb, "m/t"))
        assert len(seen["p"]) == len(seen["j"])
        for (pi, pr), (ji, jr) in zip(seen["p"], seen["j"]):
            np.testing.assert_array_equal(pi, ji)
            np.testing.assert_array_equal(pr, jr)
    assert overflowed and l2_full > 5 and pc._next_free == pc.capacity
    assert p.vdb.stats()["hits"] == j.vdb.stats()["hits"] > 0
    p.close()


@pytest.mark.parametrize("switch_s", [1e-5, 5e-3])
def test_four_threads_probing_tables_leave_a_serial_state(tmp_path,
                                                          switch_s):
    """Four host threads probing four tables of one HPS at once (each
    table's stream in order) leave every cache's slots, counters and
    residents, every L2 namespace and the hit / miss counts as a serial
    run of the same probes does: with the threads switched every 10 us
    (between nearly any two host calls) and at the default interval."""
    rng = np.random.default_rng(4)
    pdb = PersistentDB(str(tmp_path))
    tabs = tuple(EmbeddingTableConfig(f"t{i}", 2000, DIM) for i in range(4))
    for t in tabs:
        pdb.create_table("m", t.name, 2000, DIM, initial=rng.standard_normal(
            (2000, DIM)).astype(np.float32))
    from repro_torch.core.hps.volatile_db import VolatileDB

    def streams(k):
        r = np.random.default_rng(50 + k)
        out = []
        for i in range(25):
            ids = (r.zipf(1.2, 96) + 53 * i) % 2000
            ids[r.random(96) < 0.05] = -1
            out.append(ids.astype(np.int64))
        return out

    def run(hps, k, slots):
        cache = hps.caches[f"t{k}"]
        for ids in streams(k):
            plan = cache.probe(ids)
            cache.commit(plan)
            slots[k].append(plan.slots)

    def build():
        return HPS("m", tabs, pdb, cache_capacity=64, device="cpu",
                   vdb=VolatileDB(shards=2, capacity_per_shard=90))

    serial, s_slots = build(), {k: [] for k in range(4)}
    for k in range(4):
        run(serial, k, s_slots)
    par, p_slots = build(), {k: [] for k in range(4)}
    errors = []
    start = threading.Barrier(4)

    def worker(k):
        try:
            start.wait()
            run(par, k, p_slots)
        except Exception as e:      # pragma: no cover
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(switch_s)
    try:
        ts = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in ts)
    for k in range(4):
        for a, b in zip(s_slots[k], p_slots[k]):
            np.testing.assert_array_equal(a, b)
        a, b = serial.caches[f"t{k}"], par.caches[f"t{k}"]
        np.testing.assert_array_equal(a._freq, b._freq)
        np.testing.assert_array_equal(a._id_of, b._id_of)
        assert a.counters() == b.counters()
        for x, y in zip(_l2_state(serial.vdb, f"m/t{k}"),
                        _l2_state(par.vdb, f"m/t{k}")):
            assert x[0] == y[0]
            for u, v in zip(x[1:], y[1:]):
                np.testing.assert_array_equal(u, v)
    assert serial.vdb.stats() == par.vdb.stats()
    assert serial.stats()["l3_fetches"] == par.stats()["l3_fetches"]
    serial.close()
    par.close()


def test_host_calls_keep_the_interpreter_lock_and_are_counted():
    """The host library is bound with ``ctypes.PyDLL`` (a served call
    takes microseconds and keeps the interpreter lock, so no thread
    waits to win it back while holding a cache's, a namespace's or the
    store's lock), and each call is counted by its entry point."""
    import ctypes
    from repro_torch.core.hps import _host
    from repro_torch.core.hps.id_index import IdIndex
    idx = IdIndex(np.arange(5), np.arange(5))
    assert isinstance(_host.lib(), ctypes.PyDLL)
    assert _host.lib().hps_map_find._flags_ & ctypes._FUNCFLAG_PYTHONAPI
    _host.CALLS.reset()
    ids = np.arange(-2, 8)
    want = np.where((ids >= 0) & (ids < 5), ids, -1)
    np.testing.assert_array_equal(idx.find(ids), want)
    np.testing.assert_array_equal(idx.find(ids[:3]), want[:3])
    assert _host.CALLS.snapshot() == {"hps_map_find": 2}


@pytest.mark.parametrize("shape", [(6, DIM - 1), (5, DIM), (1, DIM), (6,)])
def test_l2_insert_rejects_rows_of_another_shape(shape):
    """An L2 insert whose rows are not ``[len(ids), D]`` of the shard's
    width raises ``ValueError`` before any host call (a narrower, a
    shorter, a one-row broadcast or a flat block), as numpy's assignment
    did, and leaves the namespace as it was."""
    from repro_torch.core.hps.volatile_db import VolatileDB
    vdb = VolatileDB(shards=1, capacity_per_shard=16)
    rng = np.random.default_rng(7)
    vdb.insert("t", np.arange(4), rng.standard_normal((4, DIM)).astype(
        np.float32))
    before = vdb.query("t", np.arange(4))
    with pytest.raises(ValueError):
        vdb.insert("t", np.arange(10, 16),
                   rng.standard_normal(shape).astype(np.float32))
    mask, rows = vdb.query("t", np.arange(10, 16))
    assert not mask.any() and rows is None
    after = vdb.query("t", np.arange(4))
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    assert vdb.size("t") == 4


@pytest.mark.parametrize("ids", [
    [0, 9, 3, 3, 9],
    [[1, 2], [-1, -10]],
    [],
    np.array([7], np.int32),
])
def test_pdb_fetch_is_numpy_indexing(tmp_path, ids):
    """``PersistentDB.fetch`` (one gather of the host library) returns what
    indexing the memmap returns: the shape of ``ids`` plus the row, a
    negative id counted from the end, a fresh f32 array; an id out of
    range raises ``IndexError`` on either side."""
    rows = np.random.default_rng(0).standard_normal((10, 3)).astype(
        np.float32)
    pdb = PersistentDB(str(tmp_path))
    pdb.create_table("m", "t", 10, 3, initial=rows)
    got = pdb.fetch("m", "t", ids)
    want = np.asarray(rows[np.asarray(ids, np.int64)], np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got[...] = 0
    np.testing.assert_array_equal(pdb.fetch("m", "t", ids), want)
    for bad in ([10], [-11], [3, 12]):
        with pytest.raises(IndexError):
            rows[bad]
        with pytest.raises(IndexError):
            pdb.fetch("m", "t", bad)


def _check_to_device_many(device):
    from repro_torch import device as devmod
    arrays = [np.arange(5, dtype=np.int32), None,
              np.ones((3, 2), np.float16), np.array([-1, 7], np.int64),
              np.zeros(0, np.int8), np.full((2, 3), 0.5, np.float32)]
    out = devmod.to_device_many(arrays, device)
    assert out[1] is None
    for a, t in zip(arrays, out):
        if a is not None:
            assert t.shape == a.shape and t.device.type == device.type
            np.testing.assert_array_equal(t.cpu().numpy(), a)


def test_to_device_many_packs_typed_views():
    _check_to_device_many(torch.device("cpu"))


# ---------------------------------------------------------------------------
# on the card: the striped L1 through K1, K5 and K6, and a refresh
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _port_tables(root):
    """The module's tables, written by the port's PDB under ``root``."""
    pdb = PersistentDB(root)
    rng = np.random.default_rng(0)
    for t in _tables(EmbeddingTableConfig):
        pdb.create_table("m", t.name, t.vocab_size, t.dim,
                         initial=rng.standard_normal(
                             (t.vocab_size, t.dim)).astype(np.float32))
    pdb.flush()
    return pdb


@pytest.mark.cuda
def test_cuda_to_device_many_is_one_pinned_copy(cuda):
    _check_to_device_many(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_cuda_striped_reads_match_unstriped(tmp_path, cuda, shards,
                                            payload_dtype):
    from repro_torch.kernels._build import LAUNCHES
    pdb = _port_tables(str(tmp_path))
    tables = _tables(EmbeddingTableConfig)
    hps = {(dev.type, n): HPS("m", tables, pdb, cache_capacity=16,
                              cache_shards=n, payload_dtype=payload_dtype,
                              device=dev)
           for dev in (cuda, torch.device("cpu")) for n in (1, shards)}
    pooled = "lookup_fwd" if payload_dtype == "f32" else \
        "dequant_gather_rows"
    query = "gather_rows" if payload_dtype == "f32" else \
        "dequant_gather_rows"
    try:
        for c in _stream(n=4, b=300):
            outs = {}
            for key, h in hps.items():
                LAUNCHES.reset()
                outs[key] = h.lookup(c).cpu()
                torch.cuda.synchronize()
                assert LAUNCHES.snapshot() == (
                    {pooled: 1} if key[0] == "cuda" else {}), key
            for key, out in outs.items():
                assert torch.equal(out, outs[("cpu", 1)]), key
            ids = c[:, 0, 0].astype(np.int64)
            rows = {}
            for key, h in hps.items():
                LAUNCHES.reset()
                rows[key] = h.caches["t0"].query(ids).cpu()
                torch.cuda.synchronize()
                assert LAUNCHES.snapshot() == (
                    {query: 1} if key[0] == "cuda" else {}), key
            for key, r in rows.items():
                assert torch.equal(r, rows[("cpu", 1)]), key
    finally:
        for h in hps.values():
            h.close()


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("payload_dtype", ["f32", "int8"])
def test_cuda_refresh_after_an_update(tmp_path, cuda, shards, payload_dtype):
    from repro_torch.core.hps.message_bus import MessageBus, Producer
    pdb = _port_tables(str(tmp_path))
    bus = MessageBus()
    hps = HPS("m", _tables(EmbeddingTableConfig), pdb, cache_capacity=64,
              cache_shards=shards, bus=bus, payload_dtype=payload_dtype,
              device=cuda)
    cat = _stream(n=1, b=200, seed=3)[0]
    hps.lookup(cat)                              # fill the L1
    rng = np.random.default_rng(8)
    prod = Producer(bus, "m")
    for t in hps.tables:
        prod.send(t.name, np.arange(t.vocab_size), rng.standard_normal(
            (t.vocab_size, DIM)).astype(np.float32) * 3)
    prod.flush(version=1)
    assert hps.apply_updates() == len(VOCABS)
    assert hps.refresh_backlog() > 0
    while hps.refresh_backlog():
        hps.refresh_step(budget=16)
    torch.cuda.synchronize()
    exact, bound = _port_rounding_bound(pdb, cat, payload_dtype)
    got = hps.lookup(cat).cpu().numpy()
    assert (np.abs(got - exact) <= bound).all()
    hps.close()


def _port_rounding_bound(pdb, cat, payload_dtype):
    """:func:`_rounding_bound`'s f32 rows and int8 bound, read through the
    port's PDB (f32: bound 0)."""
    exact = []
    for ti, t in enumerate(_tables(EmbeddingTableConfig)):
        ids = cat[:, ti, 0]
        rows = pdb.fetch("m", t.name, np.maximum(ids, 0))
        exact.append(np.where(ids[:, None] >= 0, rows, 0.0))
    exact = np.stack(exact, axis=1).astype(np.float32)
    if payload_dtype == "int8":
        step = np.abs(exact).max(axis=-1, keepdims=True) / 127.0
        return exact, np.broadcast_to(step / 2 * (1 + 1e-5), exact.shape)
    return exact, np.zeros_like(exact)
