"""The port's Embedding Training Cache and parameter servers against the
JAX package's, on the CPU.

* The reference's ``tests/test_etc.py`` cases on the port: residency,
  eviction writeback, the capacity checks, flush, both PS tiers, the
  touched keyset, and a training loop through a cache much smaller than
  the tables.
* The same numpy id streams through both packages' caches and PSes (the
  cache rows changed the same way between prepares): remapped slots,
  resident ids, ``drain_touched``, the pull and eviction counters and the
  PS bytes equal exactly.
* ``cached_lookup`` against the reference's, forward and gradient, f32
  within 1e-5.
* ``cuda``-marked: K1 and K3 on the flattened cache bit-exact to their
  plain versions (K3 to its chunked plain version, the kernel's order of
  adds), one launch each.

The reference is imported inside a fixture, so the ``cuda`` cases also
run where only torch is installed.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.configs.base import EmbeddingTableConfig, TrainConfig
from repro_torch.core.etc.cache import EmbeddingTrainingCache, cached_lookup
from repro_torch.core.etc.parameter_server import CachedPS, StagedPS

CPU = "cpu"


@pytest.fixture(scope="module")
def J():
    """The JAX reference's ETC modules."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs.base import EmbeddingTableConfig as JTable
    from repro.core.etc import cache, parameter_server
    return type("J", (), {"jax": jax, "jnp": jnp, "Table": JTable,
                          "cache": cache, "ps": parameter_server})


def _tables(n=2, vocab=100, dim=8, cls=EmbeddingTableConfig):
    return [cls(f"t{i}", vocab, dim, hotness=2) for i in range(n)]


def _etc(tabs, capacity, ps):
    return EmbeddingTrainingCache(tabs, capacity=capacity, ps=ps, device=CPU)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_etc.py) on the port
# ---------------------------------------------------------------------------

def test_prepare_makes_ids_resident():
    tabs = _tables()
    ps = StagedPS(tabs)
    etc = _etc(tabs, 16, ps)
    params = etc.init_params()
    cat = np.asarray([[[3, 5], [7, -1]], [[3, 9], [2, 2]]], np.int32)
    params, remapped = etc.prepare(params, cat)
    # every valid id got a slot, padding stayed -1
    assert (remapped[cat >= 0] >= 0).all()
    assert (remapped[cat < 0] == -1).all()
    # lookup through the cache equals pulling rows from the PS directly
    out = cached_lookup(params, torch.from_numpy(remapped)).numpy()
    for b in range(2):
        for t in range(2):
            want = np.zeros(8)
            for h in range(2):
                v = cat[b, t, h]
                if v >= 0:
                    want = want + ps.pull(tabs[t].name, np.asarray([v]))[0]
            np.testing.assert_allclose(out[b, t], want, rtol=1e-5)


def test_eviction_writes_back_to_ps():
    tabs = _tables(n=1, vocab=100)
    ps = StagedPS(tabs)
    etc = _etc(tabs, 4, ps)
    params = etc.init_params()
    cat = np.arange(4, dtype=np.int32).reshape(4, 1, 1)
    params, rm = etc.prepare(params, cat)
    orig = ps.pull("t0", np.arange(4))   # what prepare() staged
    # mutate the cached rows (simulating a train step)
    params = dict(params)
    params["cache"] = params["cache"] + 1.0
    # now demand 4 new ids -> all old rows must be evicted + written back
    cat2 = (np.arange(4, dtype=np.int32) + 50).reshape(4, 1, 1)
    params, rm2 = etc.prepare(params, cat2)
    assert etc.evictions == 4
    rows = ps.pull("t0", np.arange(4))
    np.testing.assert_allclose(rows, orig + 1.0, rtol=1e-6)
    assert etc.pulls == 8


def test_capacity_exceeded_in_one_batch_raises_or_survives():
    tabs = _tables(n=1, vocab=100)
    etc = _etc(tabs, 4, StagedPS(tabs))
    params = etc.init_params()
    cat = np.arange(4, dtype=np.int32).reshape(4, 1, 1)
    params, _ = etc.prepare(params, cat)
    assert etc.pulls == 4


def test_current_batch_ids_survive_eviction():
    """Eviction must never evict ids needed by the batch being staged."""
    tabs = _tables(n=1, vocab=100)
    etc = _etc(tabs, 4, StagedPS(tabs))
    params = etc.init_params()
    cat = np.arange(4, dtype=np.int32).reshape(4, 1, 1)
    params, _ = etc.prepare(params, cat)
    cat2 = np.asarray([0, 50, 51, 52], np.int32).reshape(4, 1, 1)
    params, rm = etc.prepare(params, cat2)
    assert (rm >= 0).all()


def test_batch_exceeding_capacity_raises():
    tabs = _tables(n=1, vocab=100)
    etc = _etc(tabs, 4, StagedPS(tabs))
    params = etc.init_params()
    cat = np.arange(8, dtype=np.int32).reshape(8, 1, 1)
    with pytest.raises(ValueError, match="capacity"):
        etc.prepare(params, cat)


def test_flush_persists_everything():
    tabs = _tables(n=1, vocab=50)
    ps = StagedPS(tabs)
    etc = _etc(tabs, 8, ps)
    params = etc.init_params()
    cat = np.asarray([1, 2, 3], np.int32).reshape(3, 1, 1)
    params, rm = etc.prepare(params, cat)
    params = dict(params)
    params["cache"] = params["cache"] * 0 + 42.0
    etc.flush(params)
    for i in (1, 2, 3):
        np.testing.assert_allclose(ps.pull("t0", np.asarray([i]))[0], 42.0)


def test_cached_ps_disk_roundtrip(tmp_path):
    tabs = _tables(n=2, vocab=64, dim=4)
    ps = CachedPS(tabs, str(tmp_path / "ps"))
    rows = ps.pull("t0", np.asarray([3, 5]))
    ps.push("t0", np.asarray([3]), np.ones((1, 4), np.float32) * 7)
    ps.flush()
    ps2 = CachedPS(tabs, str(tmp_path / "ps"))
    np.testing.assert_allclose(ps2.pull("t0", np.asarray([3]))[0], 7.0)
    np.testing.assert_allclose(ps2.pull("t0", np.asarray([5]))[0], rows[1])


@pytest.mark.parametrize("shards", [1, 3])
def test_staged_ps_churn_roundtrip(shards):
    """Batched pull/push round-trip under churn: interleaved batched
    pushes (with duplicate ids) and pulls across shards."""
    tabs = _tables(n=1, vocab=1000, dim=6)
    ps = StagedPS(tabs, shards=shards)
    rng = np.random.default_rng(3)
    oracle = {}
    for _ in range(20):
        ids = rng.integers(0, 1000, 64).astype(np.int64)
        rows = rng.normal(size=(64, 6)).astype(np.float32)
        ps.push("t0", ids, rows)
        for j, i in enumerate(ids):      # keep-last duplicate semantics
            oracle[int(i)] = rows[j]
        probe = np.asarray(sorted(oracle), np.int64)
        got = ps.pull("t0", probe)
        want = np.stack([oracle[int(i)] for i in probe])
        np.testing.assert_array_equal(got, want)


def test_staged_ps_state_roundtrip():
    tabs = _tables(n=1, vocab=100, dim=4)
    ps = StagedPS(tabs)
    ids = np.asarray([7, 3, 7, 50], np.int64)       # dup keeps last
    ps.push_state("t0", ids, np.asarray([1., 2., 3., 4.], np.float32))
    got = ps.pull_state("t0", np.asarray([3, 7, 50, 99]))
    np.testing.assert_array_equal(got, [2., 3., 4., 0.])


def test_cached_ps_state_survives_reopen(tmp_path):
    tabs = _tables(n=1, vocab=32, dim=4)
    ps = CachedPS(tabs, str(tmp_path / "ps"))
    ps.push_state("t0", np.asarray([5]), np.asarray([9.0], np.float32))
    ps.flush()
    ps2 = CachedPS(tabs, str(tmp_path / "ps"))
    np.testing.assert_allclose(ps2.pull_state("t0", np.asarray([5])), [9.0])


def test_pull_after_push_is_deterministic_per_id():
    """A never-pushed id pulls the SAME default row every time."""
    tabs = _tables(n=1, vocab=100, dim=4)
    ps = StagedPS(tabs)
    a = ps.pull("t0", np.asarray([11, 13]))
    b = ps.pull("t0", np.asarray([13, 11]))
    np.testing.assert_array_equal(a[0], b[1])
    np.testing.assert_array_equal(a[1], b[0])


def test_capacity_clamps_to_largest_vocab_with_warning():
    tabs = _tables(n=1, vocab=10)
    with pytest.warns(RuntimeWarning, match="clamping"):
        etc = _etc(tabs, 64, StagedPS(tabs))
    assert etc.capacity == 10
    mixed = [tabs[0], EmbeddingTableConfig("big", 100, 8, hotness=2)]
    with pytest.warns(RuntimeWarning, match="fit entirely"):
        etc = _etc(mixed, 64, StagedPS(mixed))
    assert etc.capacity == 64


def test_int32_row_ids_bound_the_flattened_cache():
    """``T * C`` must stay under 2**31: the kernels take int32 rows."""
    tabs = [EmbeddingTableConfig(f"t{i}", 1 << 30, 4) for i in range(2)]
    with pytest.raises(ValueError, match="int32"):
        _etc(tabs, 1 << 30, ps=None)


def test_drain_touched_includes_evicted_ids():
    tabs = _tables(n=1, vocab=100)
    etc = _etc(tabs, 4, StagedPS(tabs))
    params = etc.init_params()
    params, _ = etc.prepare(
        params, np.arange(4, dtype=np.int32).reshape(4, 1, 1))
    params, _ = etc.prepare(
        params, (np.arange(4, dtype=np.int32) + 50).reshape(4, 1, 1))
    touched = etc.drain_touched(0)
    np.testing.assert_array_equal(touched, [0, 1, 2, 3, 50, 51, 52, 53])
    assert etc.drain_touched(0).size == 0    # drained


def test_etc_training_integration():
    """Train with cache capacity << vocab; final PS state reflects
    training."""
    from repro_torch.optim.sparse import rowwise_adagrad
    from repro_torch.train.train_step import value_and_grad

    tabs = _tables(n=2, vocab=200, dim=4)
    ps = StagedPS(tabs)
    etc = _etc(tabs, 32, ps)
    params = etc.init_params()
    opt = rowwise_adagrad(TrainConfig(learning_rate=0.5))
    rng = np.random.default_rng(0)
    target = torch.ones((8, 2, 4))

    def step(params, remapped):
        loss, g = value_and_grad(
            lambda p: ((cached_lookup(p, remapped) - target) ** 2).mean(),
            {"cache": params["cache"]})
        with torch.no_grad():
            new_cache, acc_state = opt.update(
                {"c": g["cache"].reshape(-1, 4)},
                {"acc": {"c": params["acc"].reshape(-1)}},
                {"c": params["cache"].reshape(-1, 4)})
        return {"cache": new_cache["c"].reshape(params["cache"].shape),
                "acc": acc_state["acc"]["c"].reshape(params["acc"].shape)
                }, float(loss)

    losses = []
    for _ in range(20):
        cat = rng.integers(0, 200, (8, 2, 2)).astype(np.int32)
        params, remapped = etc.prepare(params, cat)
        params, loss = step(params, torch.from_numpy(remapped))
        losses.append(loss)
    etc.flush(params)
    assert etc.pulls > 32          # cache thrashed (capacity << working set)
    assert etc.evictions > 0
    assert losses[-1] < losses[0]  # learning happened through the cache


# ---------------------------------------------------------------------------
# the same id streams through both packages
# ---------------------------------------------------------------------------

def _ps_pair(J, kind, tabs, jtabs, tmp_path):
    if kind == "cached":
        return (CachedPS(tabs, str(tmp_path / "port"), seed=3),
                J.ps.CachedPS(jtabs, str(tmp_path / "jax"), seed=3))
    shards = 3 if kind == "staged3" else 1
    return (StagedPS(tabs, seed=3, shards=shards),
            J.ps.StagedPS(jtabs, seed=3, shards=shards))


def _ps_bytes(ps, tables):
    """Every byte the PS holds: per table and shard the ids, rows and
    accumulators (staged), or the memmaps (cached)."""
    out = {}
    for t in tables:
        if hasattr(ps, "_maps"):
            out[t] = (np.asarray(ps._maps[t]).tobytes(),
                      np.asarray(ps._state_maps[t]).tobytes())
        else:
            out[t] = tuple((s.ids.tobytes(), s.rows.tobytes())
                           for s in ps._shards[t] + ps._state[t])
    return out


@pytest.mark.parametrize("kind,capacity", [
    ("staged", 12), ("staged3", 12), ("staged", 64), ("cached", 12)])
def test_id_streams_match_jax(J, kind, capacity, tmp_path):
    """The same id stream, with the same change to the cached rows after
    each prepare (a train step's stand-in), through both packages: the
    remapped slots, resident ids, counters, touched keysets and PS bytes
    are equal."""
    vocabs, dim = (50, 30, 7), 4
    tabs = [EmbeddingTableConfig(f"t{i}", v, dim, hotness=3)
            for i, v in enumerate(vocabs)]
    jtabs = [J.Table(f"t{i}", v, dim, hotness=3)
             for i, v in enumerate(vocabs)]
    ps, jps = _ps_pair(J, kind, tabs, jtabs, tmp_path)
    etc = _etc(tabs, capacity, ps)
    jetc = J.cache.EmbeddingTrainingCache(jtabs, capacity=capacity, ps=jps)
    params, jparams = etc.init_params(), jetc.init_params()
    rng = np.random.default_rng(11)
    for step in range(12):
        cat = np.stack([rng.integers(-1, v, (4, 3)) for v in vocabs],
                       axis=1).astype(np.int32)
        params, rem = etc.prepare(params, cat)
        jparams, jrem = jetc.prepare(jparams, cat)
        np.testing.assert_array_equal(rem, jrem)
        for ti in range(len(tabs)):
            np.testing.assert_array_equal(etc.resident_ids(ti),
                                          jetc.resident_ids(ti))
        assert (etc.pulls, etc.evictions) == (jetc.pulls, jetc.evictions)
        np.testing.assert_array_equal(params["cache"].numpy(),
                                      np.asarray(jparams["cache"]))
        np.testing.assert_array_equal(params["acc"].numpy(),
                                      np.asarray(jparams["acc"]))
        delta = rng.normal(size=tuple(params["cache"].shape)) \
            .astype(np.float32)
        dacc = rng.random(tuple(params["acc"].shape)).astype(np.float32)
        params = {"cache": params["cache"] + torch.from_numpy(delta),
                  "acc": params["acc"] + torch.from_numpy(dacc)}
        jparams = {"cache": jparams["cache"] + delta,
                   "acc": jparams["acc"] + dacc}
    assert etc.evictions > 0 or capacity >= max(vocabs)
    etc.flush(params)
    jetc.flush(jparams)
    for ti in range(len(tabs)):
        np.testing.assert_array_equal(etc.drain_touched(ti),
                                      jetc.drain_touched(ti))
        ids, rows = etc.dirty_rows(params, ti)
        jids, jrows = jetc.dirty_rows(jparams, ti)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(rows, jrows)
    if kind == "cached":
        ps.flush()
        jps.flush()
    assert _ps_bytes(ps, [t.name for t in tabs]) == \
        _ps_bytes(jps, [t.name for t in tabs])


@pytest.mark.parametrize("kind", ["staged", "staged3", "cached"])
def test_ps_default_rows_match_jax(J, kind, tmp_path):
    """Pulls of never-pushed ids draw the same default rows (one seeded
    generator per PS) and leave the same bytes."""
    tabs = _tables(n=2, vocab=300, dim=5)
    jtabs = _tables(n=2, vocab=300, dim=5, cls=J.Table)
    ps, jps = _ps_pair(J, kind, tabs, jtabs, tmp_path)
    rng = np.random.default_rng(5)
    for _ in range(6):
        t = f"t{rng.integers(0, 2)}"
        ids = rng.integers(0, 300, 40).astype(np.int64)
        np.testing.assert_array_equal(ps.pull(t, ids), jps.pull(t, ids))
        np.testing.assert_array_equal(ps.pull_state(t, ids),
                                      jps.pull_state(t, ids))
        rows = rng.normal(size=(10, 5)).astype(np.float32)
        ps.push(t, ids[:10], rows)
        jps.push(t, ids[:10], rows)
    assert _ps_bytes(ps, ["t0", "t1"]) == _ps_bytes(jps, ["t0", "t1"])


# ---------------------------------------------------------------------------
# cached_lookup against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("t,c,d,h", [(3, 17, 8, 1), (2, 40, 16, 4)])
def test_cached_lookup_matches_jax(J, use_kernels, t, c, d, h):
    rng = np.random.default_rng(t * 100 + h)
    cache = rng.normal(size=(t, c, d)).astype(np.float32)
    rem = rng.integers(-1, c, (9, t, h)).astype(np.int32)
    w = rng.normal(size=(9, t, d)).astype(np.float32)
    jp = {"cache": J.jnp.asarray(cache), "acc": J.jnp.zeros((t, c))}
    want = np.asarray(J.cache.cached_lookup(jp, J.jnp.asarray(rem)))
    jgrad = np.asarray(J.jax.grad(
        lambda cc: (J.cache.cached_lookup({"cache": cc}, J.jnp.asarray(rem))
                    * w).sum())(jp["cache"]))
    pc = torch.from_numpy(cache).requires_grad_(True)
    got = cached_lookup({"cache": pc}, torch.from_numpy(rem),
                        use_kernels=use_kernels)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pc.grad.numpy(), jgrad, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card: K1 and K3 over the flattened cache
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,c,d,h", [(26, 4096, 128, 1), (3, 1000, 16, 3),
                                     (5, 333, 33, 2)])
def test_cuda_cached_lookup_kernels_bit_exact(cuda, t, c, d, h):
    from repro_torch.kernels import embedding_lookup as k1
    from repro_torch.kernels._build import LAUNCHES
    g = torch.Generator().manual_seed(t + c)
    cache = torch.randn((t, c, d), generator=g).to(cuda)
    rem = torch.randint(-1, c, (257, t, h), generator=g,
                        dtype=torch.int32).to(cuda)
    before = LAUNCHES.snapshot()
    leaf = cache.clone().requires_grad_(True)
    out = cached_lookup({"cache": leaf}, rem)
    dout = torch.randn(out.shape, generator=g).to(cuda)
    out.backward(dout)
    torch.cuda.synchronize()
    after = LAUNCHES.snapshot()
    assert {k: after.get(k, 0) - before.get(k, 0)
            for k in ("lookup_fwd", "lookup_bwd")} == \
        {"lookup_fwd": 1, "lookup_bwd": 1}
    off = (torch.arange(t, device=cuda, dtype=torch.int32) * c).view(1, t, 1)
    rows = torch.where(rem >= 0, rem + off, -1).reshape(-1, h)
    flat = cache.view(t * c, d)
    assert torch.equal(out.reshape(-1, d), k1.lookup_fwd_plain(flat, rows))
    assert torch.equal(leaf.grad.view(t * c, d), k1.lookup_bwd_chunked_plain(
        (t * c, d), rows, dout.reshape(-1, d)))


# ---------------------------------------------------------------------------
# the ETC's bridge to the collection layout
# ---------------------------------------------------------------------------

def test_logical_tables_round_trip_every_group():
    """``import_logical_tables`` writes per-table weights back into every
    planner group, the hybrid ``hot`` / ``cold`` split included, and
    leaves a table it is not given as it was."""
    from repro_torch.configs.base import SINGLE_DEVICE
    from repro_torch.core.embedding.collection import EmbeddingCollection
    from repro_torch.core.embedding.planner import resolve_strategies
    from repro_torch.models.recsys.model import (import_logical_tables,
                                                 logical_tables)
    tabs = [EmbeddingTableConfig("small", 30, 4),
            EmbeddingTableConfig("hyb", 90, 4, strategy="hybrid",
                                 hot_fraction=0.2),
            EmbeddingTableConfig("big", 70000, 4)]
    coll = EmbeddingCollection(resolve_strategies(tabs, SINGLE_DEVICE, 64),
                               device=CPU)
    assert {"hot", "cold"} <= set(coll.groups)
    params = coll.init(torch.Generator().manual_seed(0))
    before = logical_tables(coll, params)
    new = {k: v + 1.0 for k, v in before.items() if k != "small"}
    after = logical_tables(coll, import_logical_tables(coll, params, new))
    np.testing.assert_array_equal(after["small"], before["small"])
    for k, v in new.items():
        np.testing.assert_array_equal(after[k], v)
    with pytest.raises(ValueError, match="want"):
        import_logical_tables(coll, params, {"hyb": np.zeros((3, 4))})
