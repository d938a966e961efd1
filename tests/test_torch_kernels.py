"""K1-K6 of the port against the JAX package's Pallas kernels, run in
interpret mode on the CPU as ``tests/test_kernels.py`` runs them.

On CPU tensors each wrapper takes its plain version, so these cases hold
the plain versions (and the wrappers' dispatch) to the TPU kernels on the
same numpy inputs. Tolerances: the gathers K5/K6 (f32, f16 and int8
``q * scale``) and K1 with one id per row are bit-exact; K1 with several
ids per row sums in another order (<= 1e-6 relative); K3 against the
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

from repro_torch.kernels import _build, ops
from repro_torch.kernels.dot_interaction import (
    interaction_bwd, interaction_bwd_plain, interaction_fwd,
    interaction_fwd_plain)
from repro_torch.kernels.embedding_lookup import (
    lookup_bwd, lookup_bwd_chunked_plain, lookup_bwd_plain, lookup_fwd,
    lookup_fwd_plain)
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_bwd,
                                                 flash_fwd)
from repro_torch.kernels.hps_gather import (
    dequant_gather_rows, dequant_gather_rows_plain, gather_rows,
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
    on chunk edges, all pads, D not a multiple of 32, D above 256."""
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
    assert case == "wide_d"            # two column tiles, the second ragged
    rows = _rows(rng, 100, 2, 12)
    rows[:70, 0] = 5
    return 12, 300, rows


@pytest.mark.parametrize("case", ["long_run", "chunk_edges", "all_pads",
                                  "odd_d", "wide_d"])
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


def test_wrappers_reject_mixed_or_other_devices():
    t = torch.zeros((4, 4), device="meta")
    r = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        lookup_fwd(t, r)
    with pytest.raises(ValueError):
        interaction_fwd(torch.zeros((2, 3, 4), device="meta"))


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
@pytest.mark.parametrize("self_int", [False, True])
def test_cuda_interaction_fwd(cuda, self_int, monkeypatch):
    x = torch.randn((300, 27, 128),
                    generator=torch.Generator().manual_seed(0)).to(cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    got = interaction_fwd(x, self_interaction=self_int)
    want = interaction_fwd_plain(x, self_interaction=self_int)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("payload_dtype", ["f32", "f16", "int8"])
def test_cuda_gathers(cuda, payload_dtype):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((777, 128)).astype(np.float32)
    stored, scales = quantize_rows(rows, payload_dtype)
    p = torch.from_numpy(stored).to(cuda)
    slots = torch.from_numpy(
        rng.integers(-1, 777, size=1031).astype(np.int32)).to(cuda)
    if payload_dtype != "int8":        # int8 rows are read through K6
        assert torch.equal(gather_rows(p, slots),
                           gather_rows_plain(p, slots))
    if scales is None:
        scales = (rng.random(777) + 0.5).astype(np.float32)
    if payload_dtype != "f32":
        sc = torch.from_numpy(scales).to(cuda)
        assert torch.equal(dequant_gather_rows(p, sc, slots),
                           dequant_gather_rows_plain(p, sc, slots))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("v,h,hot_rows,d", [
    (3194, 1, 64, 128), (100_000, 1, 64, 128), (1000, 3, 64, 128),
    (50, 1, 3000, 128),
    (12800, 1, 562, 3072),      # the LM's hot token table, its head's run
])
def test_cuda_lookup_bwd(cuda, v, h, hot_rows, d):
    """Bit-exact to the chunked plain version (the kernel's order of adds),
    and against the one-pass plain version (an atomic index_add_ on the
    card): a row sums up to thousands of contributions, so the f32
    sum-order bound is 1e-5 of the summed magnitudes; two launches give the
    same bits."""
    g = torch.Generator().manual_seed(v + h)
    rows = torch.randint(-1, v, (4096, h), generator=g,
                         dtype=torch.int32).to(cuda)
    rows[:hot_rows] = 7                             # a hot row's long run
    dp = torch.randn((4096, d), generator=g).to(cuda)
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
@pytest.mark.parametrize("self_int", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_interaction_bwd(cuda, self_int, dtype, monkeypatch):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((300, 27, 128), generator=g).to(dtype).to(cuda)
    p = 27 * 28 // 2 if self_int else 27 * 26 // 2
    dtri = torch.randn((300, p), generator=g).to(cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    got = interaction_bwd(x, dtri, self_interaction=self_int)
    want = interaction_bwd_plain(x, dtri, self_interaction=self_int)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["a", "c"])
def test_cuda_flash_fwd(cuda, case):
    """(a) minitron-4b's prefill shape, bf16 causal GQA g=3; (c) an odd
    length in f32, GQA g=2."""
    b, hq, hkv, s, d, dtype, tol_o, tol_l = {
        "a": (2, 24, 8, 4096, 128, torch.bfloat16, 2e-2, 1e-3),
        "c": (1, 8, 4, 1000, 64, torch.float32, 1e-4, 1e-4)}[case]
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((b * h, s, d), generator=g).to(dtype).to(cuda)
               for h in (hq, hkv, hkv))
    o, lse = flash_fwd(q, k, v, causal=True)
    po, plse = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
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


#: K8's cuda cases besides (a)-(c): every D of HEAD_DIMS in bf16 at an S
#: that no tile divides, with GQA g = 3, and D 128 (the wgmma path) with a
#: window and without the causal mask as well
_BWD_EXTRA = {f"d{d}": (1, 6, 2, 700, d, None, torch.bfloat16, True)
              for d in HEAD_DIMS}
_BWD_EXTRA["d128w"] = (1, 6, 2, 700, 128, 300, torch.bfloat16, True)
_BWD_EXTRA["d128full"] = (1, 6, 2, 700, 128, None, torch.bfloat16, False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["a", "b", "c", *_BWD_EXTRA])
def test_cuda_flash_bwd(cuda, case):
    """(a) minitron-4b's training shape, bf16 causal GQA g=3; (b)
    recurrentgemma's local attention (Hq 16, Hkv 1, D 256, window 2048) at
    an S that no tile divides; (c) an odd length in f32, GQA g=2; then each
    D of HEAD_DIMS in bf16 at S 700 with GQA g=3, so that the D = 128
    wgmma kernels and the mma.sync kernels of the other D are each held,
    and D 128 with a window and with no causal mask."""
    b, hq, hkv, s, d, window, dtype, causal = {
        "a": (1, 24, 8, 4096, 128, None, torch.bfloat16, True),
        "b": (1, 16, 1, 2500, 256, 2048, torch.bfloat16, True),
        "c": (1, 8, 4, 1000, 64, None, torch.float32, True),
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
