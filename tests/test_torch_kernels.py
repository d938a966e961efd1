"""K1-K6 of the port against the JAX package's Pallas kernels, run in
interpret mode on the CPU as ``tests/test_kernels.py`` runs them.

On CPU tensors each wrapper takes its plain version, so these cases hold
the plain versions (and the wrappers' dispatch) to the TPU kernels on the
same numpy inputs. Tolerances: the gathers K5/K6 (f32, f16 and int8
``q * scale``) and K1 with one id per row are bit-exact; K1 with several
ids per row sums in another order (<= 1e-6 relative), and so does the
grouped pooled read (K1 or K6 for all tables of a served batch at once)
against the reference's per-table ``pooled_cache_lookup``; K3 against the
Pallas lookup's VJP sums each row's few contributions in another order
(<= 1e-6); K2 and K4 are f32 dots over D or F (<= 1e-5). Both
``autograd.Function``s pass ``gradcheck`` in f64 on the plain path. The
``cuda``-marked cases launch each CUDA kernel and compare it with its
plain version on the card; they skip without one. K7 (flash attention)
is held to the Pallas kernel on the CPU in ``tests/test_torch_lm.py``; its
``cuda`` cases are here: bf16 within 2e-2 (``o``) and 1e-3 (``lse``),
f32 within 1e-4. K8 (its backward) is held to the Pallas kernel on the CPU
in ``tests/test_torch_lm_train.py``; its ``cuda`` cases are here, against
``flash_attention_bwd_ref`` on K7's own ``o`` and ``lse``: bf16 by
``ref.BF16_GRAD_RULE`` (within 1e-2 of the largest |gradient|, the whole
gradient within 1e-2 relative L2, each row within 2e-2 of its own norm;
the kernel rounds ``p`` and ``ds`` to bf16 before its products, the
plain version does not), f32 within 1e-4; two launches give the same
bits.
"""
import pytest

torch = pytest.importorskip("torch")

import types

import numpy as np

from repro_torch.kernels import _build, ops, pooled
from repro_torch.kernels.dot_interaction import (
    FWD_SLICES, bwd_smem_bytes, fwd_pair_map, fwd_smem_bytes, fwd_tiles,
    interaction_bwd, interaction_bwd_plain, interaction_fwd,
    interaction_fwd_plain)
from repro_torch.kernels.embedding_lookup import (
    lookup_bwd, lookup_bwd_chunked_plain, lookup_bwd_plain, lookup_fwd,
    lookup_fwd_grouped, lookup_fwd_grouped_plain, lookup_fwd_plain)
from repro_torch.kernels.flash_attention import (HEAD_DIMS, SHORT_KEYS,
                                                 flash_bwd, flash_fwd)
from repro_torch.kernels.hps_gather import (
    dequant_gather_grouped, dequant_gather_grouped_plain, dequant_gather_rows,
    dequant_gather_rows_plain, dequant_pooled_plain, gather_rows,
    gather_rows_plain)
from repro_torch.kernels.ref import (BF16_GRAD_RULE, LOOKUP_BWD_CHUNK,
                                     flash_attention_bwd_ref,
                                     flash_attention_ref, grad_row_error)
from repro_torch.core.hps.payload_store import quantize_rows


@pytest.fixture(scope="module")
def J():
    """The JAX reference (imported here, not at module level, so the
    ``cuda`` cases below also run where only torch is installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.hps import payload_store
    from repro.kernels import dot_interaction, embedding_lookup, hps_gather
    from repro.kernels import ops as jops
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, di=dot_interaction, el=embedding_lookup,
        hg=hps_gather, ops=jops, quantize_rows=payload_store.quantize_rows)


def _rows(rng, b, h, v, pad_frac=0.2):
    rows = rng.integers(0, v, size=(b, h)).astype(np.int32)
    rows[rng.random((b, h)) < pad_frac] = -1
    return rows


# ---------------------------------------------------------------------------
# K1 lookup_fwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,d,b,h", [
    (64, 8, 16, 1),        # one-hot
    (1000, 64, 37, 3),     # multi-hot, non-aligned batch
    (513, 16, 8, 7),       # vocab not a multiple of the block
    (300, 128, 130, 1),    # served width, non-aligned batch
])
def test_lookup_fwd_matches_pallas(J, v, d, b, h):
    rng = np.random.default_rng(v + b)
    table = rng.standard_normal((v, d)).astype(np.float32)
    rows = _rows(rng, b, h, v)
    rows[0, :] = rows[0, 0] if rows[0, 0] >= 0 else 3   # duplicate ids
    want = np.asarray(J.ops.fused_embedding_lookup(J.jnp.asarray(table),
                                                  J.jnp.asarray(rows)))
    got = lookup_fwd(torch.from_numpy(table), torch.from_numpy(rows)).numpy()
    if h == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_lookup_fwd_raw_pallas_bf16(J):
    """The raw Pallas kernel on a bf16 table (block-aligned shapes)."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((256, 32)).astype(np.float32)
    tb = J.jnp.asarray(table).astype(J.jnp.bfloat16)
    rows = _rows(rng, 16, 2, 256)
    want = np.asarray(J.el.lookup_fwd(tb, J.jnp.asarray(rows), block_b=8,
                                     block_v=128, interpret=True))
    got = lookup_fwd(torch.from_numpy(table).to(torch.bfloat16),
                     torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_lookup_fwd_all_pads_and_duplicates():
    table = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)
    pads = torch.full((3, 2), -1, dtype=torch.int32)
    assert torch.equal(lookup_fwd(table, pads), torch.zeros(3, 4))
    dup = torch.tensor([[5, 5, 5]], dtype=torch.int32)
    assert torch.equal(lookup_fwd(table, dup)[0], 3 * table[5])


# ---------------------------------------------------------------------------
# K2 interaction_fwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,f,d,self_int", [
    (8, 4, 16, False), (37, 27, 128, False), (13, 7, 16, True),
    (64, 14, 16, False)])
def test_interaction_fwd_matches_pallas(J, b, f, d, self_int):
    rng = np.random.default_rng(b * f)
    x = rng.standard_normal((b, f, d)).astype(np.float32)
    want = np.asarray(J.ops.dot_interaction(J.jnp.asarray(x), self_int))
    got = interaction_fwd(torch.from_numpy(x),
                          self_interaction=self_int).numpy()
    assert got.shape == (b, f * (f + 1) // 2 if self_int else f * (f - 1) // 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_interaction_order_is_tril_indices(J):
    """The raw Pallas kernel's selection matrix fixes np.tril_indices
    order; the port indexes the triangle directly in the same order."""
    x = np.random.default_rng(1).standard_normal((8, 5, 8)).astype(np.float32)
    s = J.jnp.asarray(J.di.selection_matrix(5))
    want = np.asarray(J.di.interaction_fwd(J.jnp.asarray(x), s, block_b=8,
                                          interpret=True))
    gram = np.einsum("bfd,bgd->bfg", x, x)
    i, j = np.tril_indices(5, -1)
    np.testing.assert_allclose(want, gram[:, i, j], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ops.dot_interaction(torch.from_numpy(x))
                               .numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("self_int", [False, True])
def test_interaction_fwd_pair_map(self_int):
    """K2's tile -> pair map (the kernel's ``pmap``, mirrored) covers every
    pair of ``np.tril_indices`` exactly once, at its own (i, j), for F =
    1..40; the tiles are the padded Gram's lower triangle of 4 x 4 tiles,
    and a tile's 16 entries fall two to each of its FWD_SLICES lanes."""
    assert FWD_SLICES * 2 == 16
    for f in range(1, 41):
        tiles = fwd_tiles(f)
        nt = -(-f // 4)
        assert len(tiles) == nt * (nt + 1) // 2
        assert tiles == sorted(tiles) and all(j <= i for i, j in tiles)
        pmap = fwd_pair_map(f, self_int)
        i, j = np.tril_indices(f, 0 if self_int else -1)
        seen = np.zeros(len(i), dtype=np.int64)
        for t, (ti, tj) in enumerate(tiles):
            for e, p in enumerate(pmap[t]):
                if p < 0:
                    continue
                seen[p] += 1
                assert (4 * ti + e // 4, 4 * tj + e % 4) == (i[p], j[p])
        assert (seen == 1).all(), f"F={f}"


def test_interaction_fwd_smem_layout():
    """The wrapper's shared-memory check follows K2's layout: two f32
    copies of x[b] (F padded to tiles of 4 rows, D to quads), two output
    rows of P + 3 floats padded to a quad, the tile map and the 16-entry
    pair map of each tile."""
    assert fwd_smem_bytes(27, 128, 351) == 4 * (2 * 28 * 128 + 2 * 356
                                                + 17 * 28)
    assert fwd_smem_bytes(5, 13, 10) == 4 * (2 * 8 * 16 + 2 * 16 + 17 * 3)
    assert fwd_smem_bytes(40, 128, 820) == 4 * (2 * 40 * 128 + 2 * 824
                                                + 17 * 55)
    assert fwd_smem_bytes(1, 1, 0) == 4 * (2 * 4 * 4 + 2 * 4 + 17)


# ---------------------------------------------------------------------------
# K3 lookup_bwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,d,b,h", [
    (64, 8, 16, 1),        # one-hot
    (1000, 64, 37, 3),     # multi-hot, pads, non-aligned batch
    (513, 16, 8, 7),       # vocab not a multiple of the block
    (40, 128, 130, 3),     # many duplicates across the batch
])
def test_lookup_bwd_matches_pallas_vjp(J, v, d, b, h):
    rng = np.random.default_rng(v * b + h)
    table = rng.standard_normal((v, d)).astype(np.float32)
    rows = _rows(rng, b, h, v)
    rows[0, :] = rows[0, 0] if rows[0, 0] >= 0 else 3   # duplicates in a row
    dpooled = rng.standard_normal((b, d)).astype(np.float32)
    _, vjp = J.jax.vjp(lambda t: J.ops.fused_embedding_lookup(
        t, J.jnp.asarray(rows)), J.jnp.asarray(table))
    want = np.asarray(vjp(J.jnp.asarray(dpooled))[0])
    got = lookup_bwd((v, d), torch.from_numpy(rows),
                     torch.from_numpy(dpooled))
    assert got.dtype == torch.float32 and tuple(got.shape) == (v, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # and through the autograd Function
    t = torch.from_numpy(table).requires_grad_(True)
    ops.fused_embedding_lookup(t, torch.from_numpy(rows)).backward(
        torch.from_numpy(dpooled))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_lookup_bwd_pads_and_duplicates():
    dp = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    rows = torch.tensor([[2, 2, -1], [-1, -1, -1], [0, 2, 5]],
                        dtype=torch.int32)
    got = lookup_bwd((6, 4), rows, dp)
    want = torch.zeros(6, 4)
    want[2] = 2 * dp[0] + dp[2]
    want[0] = dp[2]
    want[5] = dp[2]
    assert torch.equal(got, want)


def _chunk_case(case, rng):
    """(V, D, rows) for the chunked K3 order: runs across many chunks, runs
    on chunk edges, all pads, D not a multiple of 32, the narrow rows of
    D 1 and D 8 (a run across 25 and 15 chunks), D above 256."""
    if case == "long_run":             # a Zipf head's 562-row run
        rows = _rows(rng, 700, 1, 64)
        rows[rng.permutation(700)[:562]] = 7
        return 64, 40, rows
    if case == "chunk_edges":          # runs that start and end on edges
        ids = np.repeat(np.arange(8), [32, 64, 31, 1, 32, 33, 31, 32])
        return 16, 8, ids[rng.permutation(ids.size)].astype(np.int32)[:, None]
    if case == "all_pads":
        return 30, 16, np.full((90, 2), -1, np.int32)
    if case == "odd_d":                # multi-hot, pads, duplicates
        rows = _rows(rng, 150, 3, 20)
        rows[:40, :] = 3
        return 20, 45, rows
    if case == "narrow_d1":            # a wide twin's D 1: a lane a chunk
        rows = _rows(rng, 600, 1, 50)
        rows[rng.permutation(600)[:400]] = 3
        return 50, 1, rows
    if case == "narrow_d8":            # NeuMF ctx's D 8: multi-hot, pads
        rows = _rows(rng, 300, 2, 40)
        rows[rng.permutation(300)[:250], 1] = 9
        return 40, 8, rows
    assert case == "wide_d"            # two column tiles, the second ragged
    rows = _rows(rng, 100, 2, 12)
    rows[:70, 0] = 5
    return 12, 300, rows


@pytest.mark.parametrize("case", ["long_run", "chunk_edges", "all_pads",
                                  "odd_d", "narrow_d1", "narrow_d8",
                                  "wide_d"])
def test_lookup_bwd_chunked_plain_matches_pallas_vjp(J, case):
    """K3's summation order (``lookup_bwd_chunked_plain``, which the kernel
    matches bit for bit) against the Pallas lookup's VJP and the one-pass
    plain version: a run sums up to hundreds of rows in another order, so
    the f32 bound is 1e-5 of the summed magnitudes."""
    rng = np.random.default_rng(len(case))
    v, d, rows = _chunk_case(case, rng)
    b = rows.shape[0]
    dpooled = rng.standard_normal((b, d)).astype(np.float32)
    table = np.zeros((v, d), np.float32)
    _, vjp = J.jax.vjp(lambda t: J.ops.fused_embedding_lookup(
        t, J.jnp.asarray(rows)), J.jnp.asarray(table))
    want = np.asarray(vjp(J.jnp.asarray(dpooled))[0])
    r, dp = torch.from_numpy(rows), torch.from_numpy(dpooled)
    got = lookup_bwd_chunked_plain((v, d), r, dp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (v, d)
    scale = lookup_bwd_plain((v, d), r, dp.abs()).numpy()
    bound = 1e-5 * scale + 1e-6
    assert (np.abs(got.numpy() - want) <= bound).all()
    assert (np.abs(got.numpy() - lookup_bwd_plain((v, d), r, dp).numpy())
            <= bound).all()
    if case == "all_pads":
        assert not got.any()


def test_lookup_bwd_chunked_plain_order():
    """The chunked order itself. Sorted, id 0 takes positions 0-1 and id
    2's 40-row run positions 2-41; each chunk sums its part of the run in
    order from zero, and the parts are added in chunk order. With 2**24
    first and ones after, a chunk's ones after 2**24 are lost in f32 while
    the later chunks' ones are not, so the result is 2**24 plus the rows
    past the first chunk, where one running sum stays at 2**24."""
    x = torch.ones(42)
    x[0], x[40], x[41] = 2.0 ** 24, 3.0, 4.0
    dp = x[:, None].repeat(1, 2)
    rows = torch.tensor([2] * 40 + [0, 0], dtype=torch.int32)[:, None]
    got = lookup_bwd_chunked_plain((3, 2), rows, dp)
    later = 40 - (LOOKUP_BWD_CHUNK - 2)
    assert torch.equal(got[2], torch.full((2,), 2.0 ** 24 + later))
    assert torch.equal(got[0], torch.full((2,), 7.0))
    assert not got[1].any()


def test_gradcheck_fused_lookup_f64():
    g = torch.Generator().manual_seed(0)
    t = torch.randn((20, 4), generator=g, dtype=torch.float64,
                    requires_grad=True)
    rows = torch.tensor([[1, 1, -1], [3, 19, 0], [-1, -1, -1]],
                        dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda tb: ops.fused_embedding_lookup(tb, rows), (t,))
    r3 = rows.reshape(1, 3, 3)
    assert torch.autograd.gradcheck(
        lambda tb: ops.kernel_pool(tb, r3, combiner="mean"), (t,))


# ---------------------------------------------------------------------------
# K4 interaction_bwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,f,d,self_int", [
    (8, 4, 16, False), (37, 27, 128, False), (13, 7, 16, True),
    (5, 27, 128, True)])
def test_interaction_bwd_matches_pallas_vjp(J, b, f, d, self_int):
    rng = np.random.default_rng(b * f + d)
    x = rng.standard_normal((b, f, d)).astype(np.float32)
    p = f * (f + 1) // 2 if self_int else f * (f - 1) // 2
    dtri = rng.standard_normal((b, p)).astype(np.float32)
    _, vjp = J.jax.vjp(lambda xx: J.ops.dot_interaction(xx, self_int),
                       J.jnp.asarray(x))
    want = np.asarray(vjp(J.jnp.asarray(dtri))[0])
    got = interaction_bwd(torch.from_numpy(x), torch.from_numpy(dtri),
                          self_interaction=self_int)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, f, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xt = torch.from_numpy(x).requires_grad_(True)
    ops.dot_interaction(xt, self_int).backward(torch.from_numpy(dtri))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_interaction_bwd_smem_layout():
    """The wrapper's shared-memory check follows the kernel's layout: two
    f32 copies of x[b] (rows padded to quads), two of dtri[b] (padded to a
    quad), S^T and its index map (rows padded to groups of 8)."""
    assert bwd_smem_bytes(27, 128, 351) == 4 * (2 * 27 * 128 + 2 * 352
                                                + 2 * 27 * 32)
    assert bwd_smem_bytes(5, 13, 10) == 4 * (2 * 5 * 16 + 2 * 12 + 2 * 5 * 8)


def test_interaction_bwd_keeps_bf16():
    x = torch.randn((4, 5, 8), generator=torch.Generator().manual_seed(2))
    dtri = torch.randn((4, 10), generator=torch.Generator().manual_seed(3))
    xb = x.to(torch.bfloat16)
    got = interaction_bwd(xb, dtri)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, interaction_bwd(xb.float(), dtri)
                       .to(torch.bfloat16))


@pytest.mark.parametrize("self_int", [False, True])
def test_gradcheck_dot_interaction_f64(self_int):
    x = torch.randn((3, 5, 4), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda xx: ops.dot_interaction(xx, self_int), (x,))


# ---------------------------------------------------------------------------
# K5 gather_rows / K6 dequant_gather_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload_dtype", ["f32", "f16", "int8"])
@pytest.mark.parametrize("n,c,d", [(7, 24, 8), (64, 512, 32), (200, 100, 4)])
def test_gather_matches_pallas(J, payload_dtype, n, c, d):
    rng = np.random.default_rng(c + n)
    rows = rng.standard_normal((c, d)).astype(np.float32)
    rows[3] = 0.0                                  # all-zero row: scale 1
    stored, scales = quantize_rows(rows, payload_dtype)
    slots = rng.integers(-1, c, size=n).astype(np.int32)
    if scales is None:
        want = np.asarray(J.ops.cache_gather(J.jnp.asarray(stored), slots,
                                            use_kernel=True))
        got = gather_rows(torch.from_numpy(stored), torch.from_numpy(slots))
    else:
        want = np.asarray(J.ops.cache_gather(J.jnp.asarray(stored), slots,
                                            scales=J.jnp.asarray(scales),
                                            use_kernel=True))
        got = dequant_gather_rows(torch.from_numpy(stored),
                                  torch.from_numpy(scales),
                                  torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dequant_gather_f16_scaled_matches_raw_pallas(J):
    rng = np.random.default_rng(9)
    payload = rng.standard_normal((128, 16)).astype(np.float16)
    scales = (rng.random(128) + 0.5).astype(np.float32)
    slots = rng.integers(-1, 128, size=32).astype(np.int32)
    want = np.asarray(J.hg.dequant_gather_rows(
        J.jnp.asarray(payload), J.jnp.asarray(scales)[:, None],
        J.jnp.asarray(slots)[:, None], block_n=16, block_c=64, interpret=True))
    got = dequant_gather_rows(torch.from_numpy(payload),
                              torch.from_numpy(scales),
                              torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_rows_matches_reference(J):
    rows = np.random.default_rng(2).standard_normal((50, 12)).astype(
        np.float32)
    rows[0] = 0.0
    rows[1, 0] = 0.5 * np.abs(rows[1]).max()       # a tie for rint
    for mode in ("f32", "f16", "int8"):
        a, sa = quantize_rows(rows, mode)
        b, sb = J.quantize_rows(rows, mode)
        np.testing.assert_array_equal(a, b)
        assert (sa is None) == (sb is None)
        if sa is not None:
            np.testing.assert_array_equal(sa, sb)


def test_pooled_cache_lookup_paths(J):
    """f32 payload -> K1; int8 payload + scales -> K6 then the H sum."""
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((40, 8)).astype(np.float32)
    slots = _rows(rng, 9, 2, 40)
    q, sc = quantize_rows(rows, "int8")
    want = np.asarray(J.ops.pooled_cache_lookup(
        J.jnp.asarray(q), J.jnp.asarray(slots), J.jnp.asarray(sc)))
    got = ops.pooled_cache_lookup(torch.from_numpy(q),
                                  torch.from_numpy(slots),
                                  torch.from_numpy(sc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(J.ops.pooled_cache_lookup(J.jnp.asarray(rows),
                                               J.jnp.asarray(slots)))
    got = ops.pooled_cache_lookup(torch.from_numpy(rows),
                                  torch.from_numpy(slots))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the grouped pooled read (K1 for f32/f16/bf16 payloads, K6 for int8)
# ---------------------------------------------------------------------------

def _grouped_inputs(rng, mode, d, hots, b=11):
    """One ``(payload, scales)`` a table as the L1 stores it, and one
    ``[b, H_t]`` slot block a table with holes (numpy)."""
    pays, slots = [], []
    for t, h in enumerate(hots):
        rows = rng.standard_normal((30 + t, d)).astype(np.float32)
        pays.append(quantize_rows(rows, mode))
        slots.append(_rows(rng, b, h, 30 + t))
    return pays, slots


def _torch_pays(pays):
    return [(torch.from_numpy(p), None if sc is None else torch.from_numpy(sc))
            for p, sc in pays]


@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
@pytest.mark.parametrize("d", [1, 33])
def test_grouped_pooled_lookup_plain_route(J, mode, d):
    """CPU tensors: the per-table plain versions stacked, no launch, and
    each table equal to the reference's ``pooled_cache_lookup`` (bit-exact
    at H = 1, <= 1e-6 at H = 3)."""
    rng = np.random.default_rng(d)
    pays, slots = _grouped_inputs(rng, mode, d, (1, 3, 1, 3))
    _build.LAUNCHES.reset()
    got = ops.grouped_pooled_lookup(_torch_pays(pays),
                                    [torch.from_numpy(s) for s in slots])
    assert _build.LAUNCHES.snapshot() == {}
    assert got.shape == (11, 4, d) and got.dtype == torch.float32
    for t, ((p, sc), s) in enumerate(zip(pays, slots)):
        tp, ts = torch.from_numpy(p), torch.from_numpy(s)
        plain = lookup_fwd_plain(tp, ts) if sc is None else \
            dequant_pooled_plain(tp, torch.from_numpy(sc), ts)
        assert torch.equal(got[:, t], plain)
        want = np.asarray(J.ops.pooled_cache_lookup(
            J.jnp.asarray(p), J.jnp.asarray(s),
            None if sc is None else J.jnp.asarray(sc)))
        if s.shape[1] == 1:
            np.testing.assert_array_equal(got[:, t].numpy(), want)
        else:
            np.testing.assert_allclose(got[:, t].numpy(), want, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("n,want", [
    (1, [(0, 1)]), (26, [(0, 26)]), (64, [(0, 64)]),
    (65, [(0, 64), (64, 65)]), (130, [(0, 64), (64, 128), (128, 130)]),
])
def test_table_launches_split(n, want):
    """Tables per launch: at most MAX_TABLES (the kernel's descriptor
    array), in order, covering every table once."""
    assert pooled.MAX_TABLES == 64
    assert pooled.table_launches(n) == want


def test_grouped_pooled_lookup_rejects_mixed_payloads():
    f32 = (torch.zeros((4, 2)), None)
    i8 = (torch.zeros((4, 2), dtype=torch.int8), torch.ones(4))
    s = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.grouped_pooled_lookup([f32, i8], [s, s])


def test_wrappers_reject_mixed_or_other_devices():
    t = torch.zeros((4, 4), device="meta")
    r = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        lookup_fwd(t, r)
    with pytest.raises(ValueError):
        interaction_fwd(torch.zeros((2, 3, 4), device="meta"))
    # the grouped reads: a CPU first table does not hide another device
    cpu = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        lookup_fwd_grouped([cpu, t], [r, r])
    with pytest.raises(ValueError):
        dequant_gather_grouped([cpu.to(torch.int8), t.to(torch.int8)],
                               [torch.ones(4), torch.ones(4)], [r, r])


@pytest.mark.parametrize("case", ["cpu_payload", "slots_int64", "slots_1d",
                                  "scales_short", "payload_dtype"])
def test_one_table_launch_rejects(case):
    """The one-table launch (K1, K5 and K6's single-table reads) runs its
    checks inline and raises on what they refuse, before any build or
    launch: no fallback to the plain version."""
    pay = torch.zeros((4, 8))
    slots = torch.zeros((3, 1), dtype=torch.int32)
    scales, dtypes = None, (torch.float32,)
    if case == "slots_int64":
        slots = slots.long()
    elif case == "slots_1d":
        slots = slots.view(-1)
    elif case == "scales_short":
        pay, scales, dtypes = pay.to(torch.int8), torch.ones(3), (torch.int8,)
    elif case == "payload_dtype":
        pay = pay.to(torch.bfloat16)
    _build.LAUNCHES.reset()
    with pytest.raises(ValueError):
        pooled.launch_one("k", "repro_gather_rows", pay, scales, slots,
                          dtypes)
    assert _build.LAUNCHES.snapshot() == {}


def test_plain_path_launches_nothing():
    """CPU tensors run the plain versions: no kernel is built or counted."""
    _build.LAUNCHES.reset()
    lookup_fwd(torch.zeros((4, 2)), torch.zeros((2, 1), dtype=torch.int32))
    lookup_bwd((4, 2), torch.zeros((2, 1), dtype=torch.int32),
               torch.zeros((2, 2)))
    gather_rows(torch.zeros((4, 2)), torch.zeros((2,), dtype=torch.int32))
    interaction_bwd(torch.zeros((2, 3, 4)), torch.zeros((2, 3)))
    assert _build.LAUNCHES.snapshot() == {}


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", [1, 3])
def test_cuda_lookup_fwd(cuda, dtype, h):
    g = torch.Generator().manual_seed(h)
    table = torch.randn((1000, 128), generator=g).to(dtype).to(cuda)
    rows = torch.randint(-1, 1000, (257, h), generator=g,
                         dtype=torch.int32).to(cuda)
    got, want = lookup_fwd(table, rows), lookup_fwd_plain(table, rows)
    torch.cuda.synchronize()
    if h == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [0, 1, 300, 4103])
@pytest.mark.parametrize("f", [1, 2, 8, 27, 28, 40])
@pytest.mark.parametrize("d", [16, 33, 128])
@pytest.mark.parametrize("self_int", [False, True])
def test_cuda_interaction_fwd(cuda, b, f, d, self_int):
    """K2 within 1e-5 of its plain version, computed in f64 from the same
    f32 x (the exact dots: at unit-variance x and D 128 the f32 plain
    version's own rounding exceeds 1e-5 at B 4103, while the kernel's
    stays under it; ``chip_smoke.py`` prints both errors):
    F of one tile or less, whole tiles (8, 28), DLRM's 27 and 40 (two
    rounds of the block's items); D 16 and 128 (the cp.async path) and 33
    (element-wise); B 0, 1, 300 and 4103 (more samples than the grid); and
    at D 128 an x view one float into its storage (the element-wise
    path). Two launches give the same bits; one launch a call, none for an
    empty result."""
    g = torch.Generator().manual_seed(b + 100 * f + d)
    x = torch.randn((b, f, d), generator=g).to(cuda)
    views = [x]
    if d == 128:
        flat = torch.empty(x.numel() + 1, device=cuda)
        views.append(flat[1:].view(b, f, d))
        views[1].copy_(x)
    want = interaction_fwd_plain(x.double(), self_interaction=self_int)
    for xv in views:
        _build.LAUNCHES.reset()
        got = interaction_fwd(xv, self_interaction=self_int)
        again = interaction_fwd(xv, self_interaction=self_int)
        torch.cuda.synchronize()
        launched = 2 if got.numel() else 0
        assert _build.LAUNCHES.snapshot() == (
            {"interaction_fwd": launched} if launched else {})
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, again), "two launches differ"
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_interaction_fwd_rejects_oversized(cuda):
    """Two x[b] that do not fit in a block's shared memory raise before
    any launch (the wrapper checks K2's own layout)."""
    x = torch.zeros((2, 27, 4096), device=cuda)
    assert fwd_smem_bytes(27, 4096, 351) > 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        interaction_fwd(x)


@pytest.mark.cuda
@pytest.mark.parametrize("payload_dtype", ["f32", "f16", "int8"])
@pytest.mark.parametrize("d", [1, 16, 33, 128, 3072])
@pytest.mark.parametrize("n", [0, 1, 1031])
def test_cuda_gathers(cuda, payload_dtype, d, n):
    """K5 (f32 and f16 payloads) and K6's row read (f16 and int8 with
    scales), bit-exact to their plain versions with holes, at D 1 (the
    wide twins) and 33 (element-wise), 16 (the DCN / WDL / DeepFM tables),
    128 and 3072 (vector units), N 0, 1 and 1031; K5 also
    from a payload one element into its storage (element-wise). One
    ``gather_rows`` launch a K5 call, none for an empty result."""
    rng = np.random.default_rng(d + n)
    rows = rng.standard_normal((777, d)).astype(np.float32)
    stored, scales = quantize_rows(rows, payload_dtype)
    p = torch.from_numpy(stored).to(cuda)
    slots = torch.from_numpy(
        rng.integers(-1, 777, size=n).astype(np.int32)).to(cuda)
    if payload_dtype != "int8":        # int8 rows are read through K6
        flat = torch.empty(p.numel() + 1, dtype=p.dtype, device=cuda)
        shifted = flat[1:].view(p.shape)
        shifted.copy_(p)
        for pay in (p, shifted):
            _build.LAUNCHES.reset()
            got = gather_rows(pay, slots)
            torch.cuda.synchronize()
            assert _build.LAUNCHES.snapshot() == (
                {"gather_rows": 1} if n else {})
            assert got.shape == (n, d) and got.dtype == torch.float32
            assert torch.equal(got, gather_rows_plain(pay, slots))
    if scales is None:
        scales = (rng.random(777) + 0.5).astype(np.float32)
    if payload_dtype != "f32":
        sc = torch.from_numpy(scales).to(cuda)
        assert torch.equal(dequant_gather_rows(p, sc, slots),
                           dequant_gather_rows_plain(p, sc, slots))
    torch.cuda.synchronize()


#: K3's cases ``(v, h, hot_rows, d, b)``: ``rows [b, h]`` with a hot id
#: in the first ``hot_rows`` rows
_K3_CASES = [
    (3194, 1, 64, 128, 4096), (100_000, 1, 64, 128, 4096),
    (1000, 3, 64, 128, 4096), (50, 1, 3000, 128, 4096),
    # the LM's hot token table, its head's run
    (12800, 1, 562, 3072, 4096),
    # the DCN / WDL / DeepFM tables (D 16, a dist-like group among them)
    # and their dim-1 wide twins: a group of one lane a chunk
    (100_000, 1, 64, 16, 4096), (1000, 3, 64, 16, 4096),
    (50, 1, 3000, 16, 4096),
    (100_000, 1, 64, 1, 4096), (1000, 3, 64, 1, 4096),
    (50, 1, 3000, 1, 4096),
    # the graph recipes' groups: NeuMF deep and two-tower (D 64), NeuMF
    # ctx (D 8)
    (100_000, 1, 64, 64, 4096), (1000, 3, 64, 64, 4096),
    (50, 1, 3000, 64, 4096),
    (100_000, 1, 64, 8, 4096), (1000, 3, 64, 8, 4096),
    (50, 1, 3000, 8, 4096),
    # every group width of the narrow passes and the first D past them
    (100_000, 1, 64, 2, 4096), (1000, 3, 700, 24, 4096),
    (100_000, 1, 64, 32, 4096), (1000, 3, 700, 33, 4096),
    # the hand-written sort: a block of one slot a thread and a cluster of
    # two (a short fill), a block of 16 slots a thread (a long fill), the
    # longest list it takes (32,768) and one id more (torch.sort), each
    # with a run across hundreds of chunks; WDL's wide twins' vocabulary
    # (26 bits of key) at their list length; no ids
    (5000, 1, 900, 8, 1024), (5000, 1, 900, 1, 1025),
    (1 << 22, 1, 9000, 8, 16_384),
    (1 << 20, 1, 9000, 1, 32_768), (1 << 20, 1, 9000, 1, 32_769),
    (1 << 20, 1, 9000, 24, 32_768), (1 << 20, 1, 9000, 33, 32_769),
    (33_762_590, 1, 5000, 1, 106_496), (100, 1, 0, 8, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("v,h,hot_rows,d,b", _K3_CASES)
def test_cuda_lookup_bwd(cuda, v, h, hot_rows, d, b):
    """Bit-exact to the chunked plain version (the kernel's order of adds),
    and against the one-pass plain version (an atomic index_add_ on the
    card): a row sums up to thousands of contributions, so the f32
    sum-order bound is 1e-5 of the summed magnitudes; two launches give the
    same bits; one launch a call."""
    g = torch.Generator().manual_seed(v + h)
    rows = torch.randint(-1, v, (b, h), generator=g,
                         dtype=torch.int32).to(cuda)
    rows[:hot_rows] = 7                             # a hot row's long run
    if b > 2:
        rows[1, 0], rows[2, 0] = v, -5     # past the table, below it
    dp = torch.randn((b, d), generator=g).to(cuda)
    _build.LAUNCHES.reset()
    once = lookup_bwd((v, d), rows, dp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot() == {"lookup_bwd": 1}
    del once
    got = lookup_bwd((v, d), rows, dp)
    again = lookup_bwd((v, d), rows, dp)
    exact = lookup_bwd_chunked_plain((v, d), rows, dp)
    want = lookup_bwd_plain((v, d), rows, dp)
    scale = lookup_bwd_plain((v, d), rows, dp.abs())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, exact)
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,d", [(300, 27, 128), (301, 27, 128),
                                   (257, 27, 16), (129, 5, 13)])
@pytest.mark.parametrize("self_int", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_interaction_bwd(cuda, b, f, d, self_int, dtype, monkeypatch):
    """DLRM's F 27 / D 128 at a batch of 300 and at 301, which no count
    of samples a block divides, D 16 and an odd D (the element-wise
    path), with and without the diagonal, f32 and bf16 x; two launches
    give the same bits."""
    g = torch.Generator().manual_seed(b + f + d)
    x = torch.randn((b, f, d), generator=g).to(dtype).to(cuda)
    p = f * (f + 1) // 2 if self_int else f * (f - 1) // 2
    dtri = torch.randn((b, p), generator=g).to(cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    got = interaction_bwd(x, dtri, self_interaction=self_int)
    again = interaction_bwd(x, dtri, self_interaction=self_int)
    want = interaction_bwd_plain(x, dtri, self_interaction=self_int)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, again), "two launches differ"
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


#: K7's cuda cases besides (a), (c) and (d): every D of HEAD_DIMS in bf16
#: at an S that no tile divides, with GQA g = 3, so that the wgmma kernels
#: (D 64, 128, 256) and the mma.sync kernels of the other D are each held;
#: D 128 with a window, without the causal mask, and at S 64 (one whole
#: tile) and 65
_FWD_EXTRA = {f"d{d}": (1, 6, 2, 700, d, None, torch.bfloat16, True)
              for d in HEAD_DIMS}
_FWD_EXTRA["d128w"] = (1, 6, 2, 700, 128, 300, torch.bfloat16, True)
_FWD_EXTRA["d128full"] = (1, 6, 2, 700, 128, None, torch.bfloat16, False)
_FWD_EXTRA["d128s64"] = (1, 6, 2, 64, 128, None, torch.bfloat16, True)
_FWD_EXTRA["d128s65"] = (1, 6, 2, 65, 128, None, torch.bfloat16, True)

#: D 64, the wgmma kernels whose two warpgroups take 64 queries (K7, K8's
#: dq) or 64 keys (K8's dk/dv) each of a 128-row block, at their edges: a
#: window no tile divides, no causal mask, S 64 (half a block: the second
#: warpgroup has no rows) and 65, MHA without the causal mask (an encoder's
#: self-attention, g = 1) and g = 2
_D64 = {
    # the short-key form (every key tile held whole): causal with a window
    # at its longest S, and an encoder's non-causal MHA at S 300
    "d64shortw": (1, 6, 2, 512, 64, 200, torch.bfloat16, True),
    "d64shortfull": (1, 4, 4, 300, 64, None, torch.bfloat16, False),
    "d64w": (1, 6, 2, 700, 64, 300, torch.bfloat16, True),
    "d64full": (1, 6, 2, 700, 64, None, torch.bfloat16, False),
    "d64s64": (1, 6, 2, 64, 64, None, torch.bfloat16, True),
    "d64s65": (1, 6, 2, 65, 64, None, torch.bfloat16, True),
    "d64g1": (1, 4, 4, 700, 64, None, torch.bfloat16, False),
    "d64g2": (1, 4, 2, 700, 64, None, torch.bfloat16, True),
}
_FWD_EXTRA.update(_D64)

#: D 256, the wgmma kernels whose two warpgroups take two query heads of a
#: GQA group (K7, K8's dq) or split one key tile's work (K8's dk/dv), at
#: their edges: S shorter than the window, a window that no key tile (64,
#: or dq's 32) divides, a window without the causal mask, BKV 2 with g = 16
#: (the dk/dv split and reduce), g = 1 (one head a pair, one split), and
#: enough key tiles that the dk/dv grid needs no split (g = 2)
_D256 = {
    "d256short": (1, 16, 1, 300, 256, 2048, torch.bfloat16, True),
    "d256w300": (1, 6, 2, 700, 256, 300, torch.bfloat16, True),
    "d256noncausal": (1, 6, 2, 700, 256, 300, torch.bfloat16, False),
    "d256bkv2": (2, 16, 1, 1100, 256, 700, torch.bfloat16, True),
    "d256g1": (1, 2, 2, 700, 256, None, torch.bfloat16, True),
    "d256onesplit": (1, 8, 4, 4500, 256, 2048, torch.bfloat16, True),
}
_FWD_EXTRA.update(_D256)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["a", "c", "d", *_FWD_EXTRA])
def test_cuda_flash_fwd(cuda, case):
    """(a) minitron-4b's prefill shape, bf16 causal GQA g=3; (c) an odd
    length in f32, GQA g=2; (d) granite-moe-3b-a800m's prefill shape at D
    64, bf16 causal GQA g=3; then :data:`_FWD_EXTRA`. Two launches give the
    same bits."""
    b, hq, hkv, s, d, window, dtype, causal = {
        "a": (2, 24, 8, 4096, 128, None, torch.bfloat16, True),
        "c": (1, 8, 4, 1000, 64, None, torch.float32, True),
        "d": (2, 24, 8, 4096, 64, None, torch.bfloat16, True),
        **_FWD_EXTRA}[case]
    tol_o, tol_l = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-3)
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((b * h, s, d), generator=g).to(dtype).to(cuda)
               for h in (hq, hkv, hkv))
    o, lse = flash_fwd(q, k, v, causal=causal, window=window)
    o2, lse2 = flash_fwd(q, k, v, causal=causal, window=window)
    po, plse = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert torch.equal(o, o2) and torch.equal(lse, lse2), \
        "two launches differ"
    assert (o.float() - po.float()).abs().max().item() <= tol_o
    assert (lse - plse).abs().max().item() <= tol_l


@pytest.mark.cuda
def test_cuda_flash_bwd_rejects_misaligned_lse(cuda):
    """At S a multiple of 64 K8 bulk-copies the caller's own ``lse``, which
    needs a 16-byte-aligned address: a contiguous view that is not raises
    before any launch."""
    g = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn((n, 128, 128), generator=g)
                   .to(torch.bfloat16).to(cuda) for n in (3, 1, 1, 3))
    o, lse = flash_fwd(q, k, v, causal=True)
    shifted = torch.empty(lse.numel() + 1, device=cuda)[1:].view(lse.shape)
    shifted.copy_(lse)
    with pytest.raises(ValueError, match="lse is not 16-byte aligned"):
        flash_bwd(q, k, v, o, shifted, do, causal=True)


#: K8's cuda cases besides (a)-(d): every D of HEAD_DIMS in bf16 at an S
#: that no tile divides, with GQA g = 3, and D 128 (the wgmma path) with a
#: window and without the causal mask as well; then the D 256 and D 64 edges
_BWD_EXTRA = {f"d{d}": (1, 6, 2, 700, d, None, torch.bfloat16, True)
              for d in HEAD_DIMS}
_BWD_EXTRA["d128w"] = (1, 6, 2, 700, 128, 300, torch.bfloat16, True)
_BWD_EXTRA["d128full"] = (1, 6, 2, 700, 128, None, torch.bfloat16, False)
_BWD_EXTRA.update(_D256)
_BWD_EXTRA.update(_D64)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["a", "b", "c", "d", *_BWD_EXTRA])
def test_cuda_flash_bwd(cuda, case):
    """(a) minitron-4b's training shape, bf16 causal GQA g=3; (b)
    recurrentgemma's local attention (Hq 16, Hkv 1, D 256, window 2048) at
    an S that no tile divides; (c) an odd length in f32, GQA g=2; (d)
    granite-moe-3b-a800m's training shape at D 64, bf16 causal GQA g=3;
    then each D of HEAD_DIMS in bf16 at S 700 with GQA g=3, so that the
    wgmma kernels (D 64, 128, 256) and the mma.sync kernels of the other D
    are each held, D 128 with a window and with no causal mask, and the D
    256 and D 64 edges."""
    b, hq, hkv, s, d, window, dtype, causal = {
        "a": (1, 24, 8, 4096, 128, None, torch.bfloat16, True),
        "b": (1, 16, 1, 2500, 256, 2048, torch.bfloat16, True),
        "c": (1, 8, 4, 1000, 64, None, torch.float32, True),
        "d": (1, 24, 8, 4096, 64, None, torch.bfloat16, True),
        **_BWD_EXTRA}[case]
    g = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn((b * h, s, d), generator=g).to(dtype).to(cuda)
                   for h in (hq, hkv, hkv, hq))
    o, lse = flash_fwd(q, k, v, causal=causal, window=window)
    got = flash_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    again = flash_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    for name, x, y, w in zip(("dq", "dk", "dv"), got, again, want):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert torch.equal(x, y), f"{name}: two launches differ"
        if dtype == torch.float32:
            err = (x - w).abs().max().item()
            assert err <= 1e-4, f"{name}: max abs err {err} above 1e-4"
            continue
        peak, whole, worst = grad_row_error(x, w)
        assert peak <= BF16_GRAD_RULE["peak"], f"{name}: peak {peak}"
        assert whole <= BF16_GRAD_RULE["whole"], f"{name}: rel L2 {whole}"
        assert worst <= 1.0, f"{name}: worst row at {worst} of its limit"


#: K7 and K8 with a key length of their own (cross-attention: never causal,
#: never windowed): ``(b, hq, hkv, sq, sk, d, dtype)``. seamless-m4t-large-
#: v2's decoder cross-attention at full width (x64), then each kernel path
#: at lengths no tile divides, with fewer keys than queries and more: the
#: D 64 wgmma kernels (192-query and 128-key blocks), D 128, D 256 with the
#: dk/dv split over the key tiles, the mma.sync kernels and f32
_CROSS = {
    "x64": (2, 16, 16, 4096, 512, 64, torch.bfloat16),
    # its encoder (Sq == Sk, a few query tiles a head); the short-key
    # form's longest Sk with g = 4, and one key more (the long form)
    "x64encoder": (2, 16, 16, 512, 512, 64, torch.bfloat16),
    "x64threshold": (1, 8, 2, 700, SHORT_KEYS, 64, torch.bfloat16),
    "x64over": (1, 8, 2, 700, SHORT_KEYS + 1, 64, torch.bfloat16),
    "x64ragged": (1, 6, 2, 700, 300, 64, torch.bfloat16),
    "x64morekeys": (1, 4, 4, 65, 1000, 64, torch.bfloat16),
    # the short form's dk/dv split (clusters of 8 blocks at these grids)
    # with GQA: runs of whole query tiles, runs that end inside a tile's
    # heads (45 items over 8 splits), and one query tile of 40 queries
    # (2 items, 2 splits)
    "x64splitgqa": (1, 8, 2, 1000, 300, 64, torch.bfloat16),
    "x64splituneven": (1, 6, 2, 900, 300, 64, torch.bfloat16),
    "x64splitfewqueries": (1, 4, 2, 40, 300, 64, torch.bfloat16),
    "x128": (1, 6, 2, 700, 300, 128, torch.bfloat16),
    "x128morekeys": (1, 4, 4, 100, 1500, 128, torch.bfloat16),
    "x256": (1, 6, 2, 700, 300, 256, torch.bfloat16),
    "x256split": (1, 16, 1, 1100, 700, 256, torch.bfloat16),
    "x16": (1, 6, 2, 700, 300, 16, torch.bfloat16),
    "x32": (1, 6, 2, 700, 300, 32, torch.bfloat16),
    "x96": (1, 6, 2, 700, 300, 96, torch.bfloat16),
    "xf32": (1, 8, 4, 1000, 300, 64, torch.float32),
    "xf32morekeys": (1, 2, 2, 70, 500, 128, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CROSS))
def test_cuda_flash_cross(cuda, case):
    """K7 and K8 at ``Sk != Sq`` (:data:`_CROSS`) against their plain
    versions on the same inputs, non-causal and unwindowed: ``o`` and
    ``lse`` within K7's bounds, the gradients by ``BF16_GRAD_RULE`` (f32
    within 1e-4), ``o`` of ``Sq`` rows and ``dk``, ``dv`` of ``Sk``; two
    launches give the same bits."""
    b, hq, hkv, sq, sk, d, dtype = _CROSS[case]
    g = torch.Generator().manual_seed(9)
    q, do = (torch.randn((b * hq, sq, d), generator=g).to(dtype).to(cuda)
             for _ in range(2))
    k, v = (torch.randn((b * hkv, sk, d), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    o, lse = flash_fwd(q, k, v, causal=False)
    o2, lse2 = flash_fwd(q, k, v, causal=False)
    po, plse = flash_attention_ref(q, k, v, causal=False)
    got = flash_bwd(q, k, v, o, lse, do, causal=False)
    again = flash_bwd(q, k, v, o, lse, do, causal=False)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    tol_o, tol_l = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-3)
    assert o.shape == q.shape and lse.shape == q.shape[:2]
    assert torch.equal(o, o2) and torch.equal(lse, lse2), \
        "two forward launches differ"
    assert (o.float() - po.float()).abs().max().item() <= tol_o
    assert (lse - plse).abs().max().item() <= tol_l
    for name, x, y, w in zip(("dq", "dk", "dv"), got, again, want):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert torch.equal(x, y), f"{name}: two launches differ"
        if dtype == torch.float32:
            err = (x - w).abs().max().item()
            assert err <= 1e-4, f"{name}: max abs err {err} above 1e-4"
            continue
        peak, whole, worst = grad_row_error(x, w)
        assert peak <= BF16_GRAD_RULE["peak"], f"{name}: peak {peak}"
        assert whole <= BF16_GRAD_RULE["whole"], f"{name}: rel L2 {whole}"
        assert worst <= 1.0, f"{name}: worst row at {worst} of its limit"


@pytest.mark.parametrize("causal,window", [(True, None), (False, 8),
                                           (True, 8)])
def test_flash_cross_rejects_masks(causal, window):
    """A key length of its own takes no window (the reference aligns no
    positions across two lengths), and causal queries need their keys:
    with fewer keys than queries both wrappers and both plain versions
    raise before any work; the same lengths pass. (A causal call with
    more keys than queries is a shard of sequence-parallel attention:
    ``tests/test_torch_seqpar.py::test_offset_rule``.)"""
    q, do = torch.zeros((2, 6, 16)), torch.zeros((2, 6, 16))
    k, v = torch.zeros((1, 5, 16)), torch.zeros((1, 5, 16))
    lse = torch.zeros((2, 6))
    refused = "key length 5 other than|need their keys"
    with pytest.raises(ValueError, match=refused):
        flash_fwd(q, k, v, causal=causal, window=window)
    with pytest.raises(ValueError, match=refused):
        flash_bwd(q, k, v, q, lse, do, causal=causal, window=window)
    with pytest.raises(ValueError, match=refused):
        flash_attention_ref(q, k, v, causal=causal, window=window)
    k, v = torch.zeros((1, 6, 16)), torch.zeros((1, 6, 16))
    o, lse = flash_fwd(q, k, v, causal=causal, window=window)
    assert o.shape == q.shape and lse.shape == (2, 6)


@pytest.mark.cuda
def test_cuda_flash_short_key_form_bits(cuda):
    """K7's two D 64 forms give the same bits where both apply: queries
    over 512 keys (the short-key form, every key tile held whole) and over
    the same keys plus a 513th (the long form) that every query scores so
    low that its p is exactly 0 (q's first column >= 1, the key -3000
    there): the same key tiles in the same order, so ``o`` and ``lse``
    are bit-equal."""
    g = torch.Generator().manual_seed(13)
    q = torch.randn((8, 700, 64), generator=g)
    q[..., 0] = q[..., 0].abs() + 1
    n = SHORT_KEYS
    k, v = (torch.randn((2, n + 1, 64), generator=g) for _ in range(2))
    k[:, n] = 0
    k[:, n, 0] = -3000.0
    q, k, v = (t.to(torch.bfloat16).to(cuda) for t in (q, k, v))
    short = flash_fwd(q, k[:, :n].contiguous(), v[:, :n].contiguous(),
                      causal=False)
    long_ = flash_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(short[0], long_[0])
    assert torch.equal(short[1], long_[1])


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 64])
def test_cuda_flash_bwd_short_key_forms(cuda, heads):
    """K8's two D 64 forms on the inputs of
    :func:`test_cuda_flash_short_key_form_bits` (with ``heads`` query
    heads over 2 KV heads): over 512 keys the short form (K / V resident
    in the dq kernel, the dk/dv walk split over a cluster), over the same
    keys plus the 513th that no query weighs the long form. The dk/dv
    split adds its runs' partials, another order than the long form's one
    run, so dk and dv are held within ``BF16_GRAD_RULE`` of the long
    form's, and the 513th key's are 0. At 64 heads every dq block walks
    several query tiles, each the long form's walk over the same key tiles
    in the same order (the 513th key's tile adds exact zeros): dq is
    bit-equal. At 8 heads a block holds one query tile, whose key tiles
    its three warpgroups share: dq too is held within the rule."""
    g = torch.Generator().manual_seed(13)
    q = torch.randn((heads, 700, 64), generator=g)
    q[..., 0] = q[..., 0].abs() + 1
    n = SHORT_KEYS
    k, v = (torch.randn((2, n + 1, 64), generator=g) for _ in range(2))
    k[:, n] = 0
    k[:, n, 0] = -3000.0
    do = torch.randn((heads, 700, 64), generator=g)
    q, k, v, do = (t.to(torch.bfloat16).to(cuda) for t in (q, k, v, do))
    ks, vs = k[:, :n].contiguous(), v[:, :n].contiguous()
    o, lse = flash_fwd(q, ks, vs, causal=False)
    short = flash_bwd(q, ks, vs, o, lse, do, causal=False)
    long_ = flash_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    if heads == 64:
        assert torch.equal(short[0], long_[0]), "dq: the two forms differ"
    for name, x, w in zip(("dq", "dk", "dv"), short, long_):
        if name != "dq":
            assert not w[:, n:].any(), f"{name}: the 513th key's is not 0"
            w = w[:, :n]
        peak, whole, worst = grad_row_error(x, w)
        assert peak <= BF16_GRAD_RULE["peak"], f"{name}: peak {peak}"
        assert whole <= BF16_GRAD_RULE["whole"], f"{name}: rel L2 {whole}"
        assert worst <= 1.0, f"{name}: worst row at {worst} of its limit"


#: K7 and K8 with a causal query offset (a shard of sequence-parallel
#: attention: query row i at position q_pos0 + i over all Sk keys) on every
#: route, ``(sq, sk, q_pos0)`` x route: the first shard (offset 0, Sk >
#: Sq), an offset every query and key tile divides (384), one none does
#: (100, Sq 37), the last shard (q_pos0 + Sq = Sk) and a last shard over
#: 500 keys (D 64's short-key form); GQA g = 3 (at D 256
#: the dk/dv grid splits the group 3 ways: every split writes its zeros
#: for the keys no query sees)
_OFFSETS = {"first": (100, 700, 0), "tiled": (100, 700, 384),
            "ragged": (37, 700, 100), "last": (100, 700, 600),
            "shortkeys": (100, 500, 400)}
_ROUTES = {**{f"d{d}": (d, torch.bfloat16) for d in HEAD_DIMS},
           "f32": (64, torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", list(_OFFSETS))
@pytest.mark.parametrize("route", list(_ROUTES))
def test_cuda_flash_offset(cuda, route, offset):
    """K7 and K8 with ``q_pos0`` against their plain versions on the same
    inputs: ``o`` and ``lse`` within K7's bounds, the gradients by
    ``BF16_GRAD_RULE`` (f32 within 1e-4), the ``dk`` / ``dv`` rows of the
    keys past ``q_pos0 + Sq - 1`` exactly 0; two launches give the same
    bits."""
    d, dtype = _ROUTES[route]
    sq, sk, p = _OFFSETS[offset]
    g = torch.Generator().manual_seed(11)
    q, do = (torch.randn((6, sq, d), generator=g).to(dtype).to(cuda)
             for _ in range(2))
    k, v = (torch.randn((2, sk, d), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    o, lse = flash_fwd(q, k, v, q_pos0=p)
    o2, lse2 = flash_fwd(q, k, v, q_pos0=p)
    po, plse = flash_attention_ref(q, k, v, q_pos0=p)
    got = flash_bwd(q, k, v, o, lse, do, q_pos0=p)
    again = flash_bwd(q, k, v, o, lse, do, q_pos0=p)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, q_pos0=p)
    torch.cuda.synchronize()
    tol_o, tol_l = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-3)
    assert torch.equal(o, o2) and torch.equal(lse, lse2), \
        "two forward launches differ"
    assert (o.float() - po.float()).abs().max().item() <= tol_o
    assert (lse - plse).abs().max().item() <= tol_l
    for name, x, y, w in zip(("dq", "dk", "dv"), got, again, want):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert torch.equal(x, y), f"{name}: two launches differ"
        if name != "dq":
            assert not x[:, p + sq:].any(), f"{name}: unseen keys not 0"
        if dtype == torch.float32:
            err = (x - w).abs().max().item()
            assert err <= 1e-4, f"{name}: max abs err {err} above 1e-4"
            continue
        peak, whole, worst = grad_row_error(x, w)
        assert peak <= BF16_GRAD_RULE["peak"], f"{name}: peak {peak}"
        assert whole <= BF16_GRAD_RULE["whole"], f"{name}: rel L2 {whole}"
        assert worst <= 1.0, f"{name}: worst row at {worst} of its limit"


#: dkv_splits at 132 SMs (an H100 SXM): ``(bkv, s, group) -> splits``
_SPLITS_132 = {
    (1, 4096, 16): 8,     # recurrentgemma's training shape: 64 key tiles
    (1, 2500, 16): 8,     # case (b): 40 key tiles
    (2, 1100, 16): 8,     # d256bkv2: 2 x 18 key tiles
    (2, 700, 3): 3,       # d256: no divisor of 3 gives 2 blocks an SM
    (2, 700, 1): 1,       # d256g1
    (4, 4500, 2): 1,      # d256onesplit: 4 x 71 key tiles
    (8, 4096, 3): 1,      # minitron-4b's KV heads at D 256
}


@pytest.mark.parametrize("shape", list(_SPLITS_132))
def test_dkv_splits(shape):
    """K8's dk/dv grid splits a GQA group at D 256 in bf16 only, into the
    smallest divisor of g that gives DKV_WAVES blocks an SM; at splits 1
    no workspace is used."""
    from repro_torch.kernels.flash_attention import DKV_WAVES, dkv_splits
    bkv, s, group = shape
    got = dkv_splits(bkv, s, group, 256, torch.bfloat16, 132)
    assert got == _SPLITS_132[shape]
    assert group % got == 0
    if got < group:
        assert bkv * -(-s // 64) * got >= DKV_WAVES * 132
    for d, dtype in ((128, torch.bfloat16), (256, torch.float32),
                     (64, torch.bfloat16)):
        assert dkv_splits(bkv, s, group, d, dtype, 132) == 1


#: dkv_splits at D 64 in bf16 and 132 SMs: ``(bkv, sk, group, sq) ->
#: splits``; the short form (sk <= SHORT_KEYS) splits each block's items
#: over a cluster, the long form never
_SHORT_SPLITS_132 = {
    (16, 512, 1, 4096): 2,   # seamless's cross-attention: 64 blocks
    (16, 512, 1, 512): 2,    # its encoder
    (16, 513, 1, 4096): 1,   # one key more: the long form
    (16, 4096, 1, 4096): 1,  # seamless's decoder self-attention
    (8, 4096, 3, 4096): 1,   # granite-moe-3b-a800m's training shape
    (32, 512, 1, 512): 1,    # the encoder at batch 2: 128 blocks already
    (2, 512, 4, 700): 8,     # 8 blocks: the cluster's limit
    (2, 300, 2, 40): 2,      # one query tile of two heads: two items
    (2, 500, 3, 100): 4,     # six items: the largest power of two
}


@pytest.mark.parametrize("shape", list(_SHORT_SPLITS_132))
def test_dkv_splits_short_keys(shape):
    """K8's dk/dv split at D 64 in bf16: at most SHORT_KEYS keys take
    the largest power of two up to MAX_CLUSTER that keeps the grid within
    one block an SM and each split an item; more keys, f32 and D 128
    take 1."""
    from repro_torch.kernels.flash_attention import (DKV_BLOCK_64,
                                                     MAX_CLUSTER, dkv_splits)
    bkv, sk, group, sq = shape
    got = dkv_splits(bkv, sk, group, 64, torch.bfloat16, 132, sq=sq)
    assert got == _SHORT_SPLITS_132[shape]
    assert got & (got - 1) == 0 and got <= MAX_CLUSTER
    assert got <= -(-sq // 64) * group
    if got > 1:
        assert bkv * -(-sk // DKV_BLOCK_64) * got <= 132
    for d, dtype in ((64, torch.float32), (128, torch.bfloat16)):
        assert dkv_splits(bkv, sk, group, d, dtype, 132, sq=sq) == 1


@pytest.mark.parametrize("shape", list(_SPLITS_132))
def test_dkv_splits_d256_takes_no_query_length(shape):
    """At D 256 the split is over the GQA group's heads whatever the
    query length: the short form's ``sq`` changes nothing there."""
    from repro_torch.kernels.flash_attention import dkv_splits
    bkv, s, group = shape
    for sq in (1, 64, s, 4 * s):
        assert dkv_splits(bkv, s, group, 256, torch.bfloat16, 132,
                          sq=sq) == _SPLITS_132[shape]


def _cuda_grouped(cuda, mode, t, d, hots, g, offset=False):
    """``t`` tables of ``mode`` on the card (``hots`` cycled over them),
    slots [97, H] with holes; with ``offset`` each payload starts one
    element into its storage (the kernel's element-wise path)."""
    pays, slots = [], []
    for i in range(t):
        c = 200 + i
        if mode == "int8" and offset:
            p = torch.randint(-127, 128, (c * d + 1,), generator=g,
                              dtype=torch.int8)[1:].view(c, d)
            sc = torch.rand((c,), generator=g) + 0.5
        elif mode == "int8":
            p = torch.randint(-127, 128, (c, d), generator=g,
                              dtype=torch.int8)
            sc = torch.rand((c,), generator=g) + 0.5
        else:
            dt = {"f32": torch.float32, "f16": torch.float16,
                  "bf16": torch.bfloat16}[mode]
            p = torch.randn((c * d + 1,), generator=g).to(dt)
            p = (p[1:] if offset else p[:-1]).view(c, d)
            sc = None
        pays.append((p.to(cuda), None if sc is None else sc.to(cuda)))
        slots.append(torch.randint(-1, c, (97, hots[i % len(hots)]),
                                   generator=g, dtype=torch.int32).to(cuda))
    return pays, slots


def _in_order(pays, slots):
    """The kernel's order of adds on the plain route: each table's rows
    summed over h in order from zero, and the sums of their magnitudes."""
    outs, mags = [], []
    for (p, sc), s in zip(pays, slots):
        acc = mag = 0
        for h in range(s.shape[1]):
            sh = s[:, h:h + 1].contiguous()
            x = lookup_fwd_plain(p, sh) if sc is None else \
                dequant_pooled_plain(p, sc, sh)
            acc, mag = acc + x, mag + x.abs()
        outs.append(acc)
        mags.append(mag)
    return torch.stack(outs, 1), torch.stack(mags, 1)


def _grouped_pair(pays, slots):
    tabs, scs = [p for p, _ in pays], [sc for _, sc in pays]
    if scs[0] is None:
        return (lambda: lookup_fwd_grouped(tabs, slots),
                lookup_fwd_grouped_plain(tabs, slots), "lookup_fwd")
    return (lambda: dequant_gather_grouped(tabs, scs, slots),
            dequant_gather_grouped_plain(tabs, scs, slots),
            "dequant_gather_rows")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "f16", "int8"])
@pytest.mark.parametrize("t", [1, 26, 70])
@pytest.mark.parametrize("d", [1, 16, 33, 128])
def test_cuda_grouped_pooled_read(cuda, mode, t, d):
    """The grouped kernel against its plain route: bit-exact at H = 1;
    with H_t of 1 and 3 bit-exact to the plain rows added in the kernel's
    order (h in order from zero) and within 1e-6 of the summed magnitudes
    of the plain route's ``sum`` over H (another order of the f32 adds);
    one launch a 64 tables; two launches give the same bits."""
    g = torch.Generator().manual_seed(t * 1000 + d)
    for hots in ((1,), (1, 3)):
        pays, slots = _cuda_grouped(cuda, mode, t, d, hots, g)
        fn, want, name = _grouped_pair(pays, slots)
        _build.LAUNCHES.reset()
        got = fn()
        torch.cuda.synchronize()
        assert _build.LAUNCHES.snapshot() == {name: -(-t // 64)}
        assert got.shape == (97, t, d)
        if hots == (1,):
            assert torch.equal(got, want)
        else:
            ordered, mag = _in_order(pays, slots)
            assert torch.equal(got, ordered)
            assert bool(((got - want).abs() <= 1e-6 * mag + 1e-6).all())
        assert torch.equal(got, fn())
        # the served entry point routes to the same kernel
        assert torch.equal(got, ops.grouped_pooled_lookup(pays, slots))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "f16"])
def test_cuda_grouped_unaligned_payload(cuda, mode):
    """Payloads that start off a 16-byte boundary take the element-wise
    path: still bit-exact at H = 1."""
    g = torch.Generator().manual_seed(11)
    pays, slots = _cuda_grouped(cuda, mode, 3, 128, (1,), g, offset=True)
    fn, want, _ = _grouped_pair(pays, slots)
    assert torch.equal(fn(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(13, 64), (9, 16), (4, 8)])
@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("offset", [False, True])
def test_cuda_grouped_read_graph_groups(cuda, t, d, mode, offset):
    """The served read of each NeuMF HPS (13 tables at D 64, 9 at D 16, 4
    at D 8), f32 (K1) and int8 (K6): one launch, bit-exact to the plain
    version; with ``offset`` every payload starts one element off its
    unit (an int8 row of D 8 is 8 bytes: the element-wise path)."""
    g = torch.Generator().manual_seed(t * 100 + d)
    pays, slots = _cuda_grouped(cuda, mode, t, d, (1,), g, offset=offset)
    fn, want, name = _grouped_pair(pays, slots)
    _build.LAUNCHES.reset()
    got = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot() == {name: 1}
    assert got.shape == (97, t, d)
    assert torch.equal(got, want)
    assert torch.equal(got, fn())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 8])
@pytest.mark.parametrize("h", [1, 3])
def test_cuda_lookup_fwd_graph_widths(cuda, d, h):
    """K1 at the graph recipes' training widths (D 64: NeuMF deep and the
    two-tower tables; D 8: NeuMF ctx): bit-exact at H = 1, within 1e-6 at
    H = 3; two launches give the same bits."""
    g = torch.Generator().manual_seed(d + h)
    table = torch.randn((5000, d), generator=g).to(cuda)
    rows = torch.randint(-1, 5000, (4099, h), generator=g,
                         dtype=torch.int32).to(cuda)
    got, want = lookup_fwd(table, rows), lookup_fwd_plain(table, rows)
    torch.cuda.synchronize()
    if h == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, lookup_fwd(table, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3])
def test_cuda_lookup_fwd_lm_width(cuda, dtype, h):
    """K1 at the LM's width (D = 3072) with pads and an all-pad row:
    bit-exact at H = 1, within 1e-6 at H = 3."""
    g = torch.Generator().manual_seed(h)
    table = torch.randn((3000, 3072), generator=g).to(dtype).to(cuda)
    rows = torch.randint(-1, 3000, (513, h), generator=g, dtype=torch.int32)
    rows[5] = -1
    rows = rows.to(cuda)
    got, want = lookup_fwd(table, rows), lookup_fwd_plain(table, rows)
    torch.cuda.synchronize()
    assert not got[5].any()
    if h == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, lookup_fwd(table, rows))


# ---------------------------------------------------------------------------
# on the card: the model-parallel path's shard-local kernels
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("v0", [0, 700])
@pytest.mark.parametrize("h", [1, 3])
def test_cuda_masked_range_pool_with_holes(cuda, v0, h):
    """A row-range shard's pool (``masked_range_lookup`` through
    ``kernel_pool``): rows outside ``[v0, v0 + 1000)`` become -1 holes, K1
    reads them as zero (bit-exact at H = 1 to the plain pool, within 1e-6
    at H = 3) and K3's gradient leaves them out (within 1e-5 of the plain
    version's autograd)."""
    from repro_torch.core.embedding.common import masked_range_lookup
    g = torch.Generator().manual_seed(v0 + h)
    local = torch.randn((1000, 128), generator=g).to(cuda)
    rows = torch.randint(-1, 2500, (513, 4, h), generator=g,
                         dtype=torch.int32).to(cuda)
    cot = torch.randn((513, 4, 128), generator=g).to(cuda)
    outs, grads = [], []
    for fn in (ops.kernel_pool, None):
        t = local.clone().requires_grad_()
        out = masked_range_lookup(t, rows, v0, pool_fn=fn)
        (out * cot).sum().backward()
        outs.append(out.detach())
        grads.append(t.grad)
    torch.cuda.synchronize()
    if h == 1:
        assert torch.equal(outs[0], outs[1])
    else:
        torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_row_gather_and_its_adjoint(cuda):
    """The all-to-all owner's read (``ops.row_gather``): K5 rows bit-exact
    with -1 holes read as zero, and K3's adjoint within 1e-5 of the plain
    scatter-add; one launch each."""
    g = torch.Generator().manual_seed(3)
    table = torch.randn((5000, 128), generator=g).to(cuda).requires_grad_()
    slots = torch.randint(-1, 5000, (4099,), generator=g,
                          dtype=torch.int32).to(cuda)
    drows = torch.randn((4099, 128), generator=g).to(cuda)
    _build.LAUNCHES.reset()
    rows = ops.row_gather(table, slots)
    rows.backward(drows)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot() == {"gather_rows": 1, "lookup_bwd": 1}
    assert torch.equal(rows.detach(), gather_rows_plain(table.detach(),
                                                        slots))
    torch.testing.assert_close(
        table.grad, lookup_bwd_plain((5000, 128), slots.view(-1, 1), drows),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("payload_dtype", ["f32", "f16", "int8"])
def test_cuda_mesh_half_striped_read(cuda, payload_dtype):
    """The mesh half of the striped L1 over a cache mesh of one card
    named twice: each entry's owner-mapped K5 (K6 with scales) over its
    own stripes at the global slots (the second entry places its rows,
    the first reads its own and takes the others'); bit-exact to the
    unstriped read of the flat view (f32 rows, int8 / f16 ``q * scale``)
    and to the plain version; one launch an entry."""
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((8 * 512, 128)).astype(np.float32)
    stored, scales = quantize_rows(rows, payload_dtype)
    stripes = torch.from_numpy(stored).view(8, 512, 128).to(cuda)
    sc = None if scales is None and payload_dtype == "f32" else \
        torch.from_numpy(scales if scales is not None
                         else np.ones(len(rows), np.float32)).view(
            8, 512).to(cuda)
    slots = torch.from_numpy(rng.integers(-1, 8 * 512, 4099).astype(
        np.int32)).to(cuda)
    blocks, bscales = ops.place_stripes(stripes, sc, [cuda, cuda])
    _build.LAUNCHES.reset()
    got = ops.sharded_cache_gather(blocks, slots, scales=bscales,
                                   mesh=[cuda, cuda])
    torch.cuda.synchronize()
    name = "gather_rows" if sc is None else "dequant_gather_rows"
    assert _build.LAUNCHES.snapshot() == {name: 2}
    want = ops.sharded_cache_gather(stripes, slots, scales=sc)
    plain = ops.mesh_pooled_read(((blocks, bscales),), (slots.view(-1, 1),),
                                 plain=True)[:, 0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("payload_dtype,hot,tables", [
    ("f32", 1, 26), ("f32", 3, 26), ("int8", 1, 26), ("int8", 3, 26),
    ("f16", 3, 26), ("f32", 1, 70)])
def test_cuda_mesh_pooled_stack(cuda, payload_dtype, hot, tables):
    """The served pooled read of every table over a cache mesh of one card
    named twice (``hps._pooled_stack(..., mesh=)``): one owner-mapped K5
    (K6 with scales) launch an entry for all the tables (70 take two a
    launch's limit), bit-exact to the one-device read of the flat views
    (K1 / K6 in the same order of h) at H = 1 and H = 3 and so within 1e-6
    of it, and bit-exact to the plain version; tables of their own Cl."""
    from repro_torch.core.hps.hps import _pooled_stack
    rng = np.random.default_rng(7)
    mesh = [cuda, cuda]
    pays, flat, slots, fslots = [], [], [], []
    for t in range(tables):
        cl = 512 + 8 * (t % 3)
        rows = rng.standard_normal((2 * cl, 128)).astype(np.float32)
        stored, scales = quantize_rows(rows, payload_dtype)
        st = torch.from_numpy(stored).view(2, cl, 128).to(cuda)
        sc = None if scales is None else torch.from_numpy(scales).view(
            2, cl).to(cuda)
        s = rng.integers(-1, 2 * cl, size=(1031, hot)).astype(np.int32)
        sl = torch.from_numpy(s).to(cuda)
        pays.append(ops.place_stripes(st, sc, mesh))
        flat.append(ops.striped_view((st, sc)))
        slots.append(sl)
        fslots.append(ops.flatten_striped_slots(st, sl))
    combiners = ("sum",) * tables
    _build.LAUNCHES.reset()
    got = _pooled_stack(pays, slots, combiners, mesh=mesh)
    torch.cuda.synchronize()
    name = "dequant_gather_rows" if payload_dtype == "int8" else \
        "gather_rows"
    assert _build.LAUNCHES.snapshot() == {
        name: 2 * len(pooled.table_launches(tables))}
    one = _pooled_stack(flat, fslots, combiners)
    plain = ops.mesh_pooled_read(pays, slots, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, one)
    torch.testing.assert_close(got, one, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, plain)
