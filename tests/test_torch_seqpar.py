"""Sequence-parallel attention's pieces against the JAX package, on the
CPU: K7 / K8's plain versions with a causal query offset, and a shard's
part of ``seqpar_attention`` replayed rank by rank on one device.

* ``flash_attention_ref`` / ``flash_attention_bwd_ref`` with ``q_pos0``
  (query row ``i`` at position ``q_pos0 + i`` over ``Sk`` keys), through
  ``ops.flash_attention_plain``'s autograd and written out, against the
  reference's ``chunked_attention(causal=True, q_pos0=p)`` and its
  ``jax.vjp``, with ``p`` a static int and a traced scalar (the form
  ``seqpar_attention``'s shards pass); f32 within 1e-5. Offsets 0, a
  chunk multiple, one no chunk divides and the last shard's; GQA and MHA;
  every length a multiple of the reference's chunk (at a ragged length
  its ``chunked_attention`` reads the wrong keys, ROADMAP queue 3).
* the kernel path's ``autograd.Function`` with an offset (f64
  ``gradcheck``, the launches swapped for the plain versions, which must
  receive the offset);
* the calls K7 / K8 and their plain versions take and refuse
  (``ref.check_mask``);
* ``transformer.seqpar_shard`` for each rank index in turn: the shards'
  outputs concatenated equal whole causal attention, and the gradients
  summed over the shards (``dk`` / ``dv``, and ``dq``'s rows) equal the
  whole attention's (outputs bit for bit; gradients within 1e-6 of their
  largest |value|, the shards' ``dk`` / ``dv`` adding in another order);
  at a model axis of 1, or a length the axis does not divide,
  ``seqpar_attention`` is whole attention.

The mesh itself (four gloo ranks against JAX's (2, 2) ``"seq"`` runs) is
``tests/test_torch_lm_mesh.py``'s; the kernels with an offset on the card
are ``tests/test_torch_kernels.py::test_cuda_flash_offset``.
"""
import pytest

torch = pytest.importorskip("torch")

import types

import numpy as np
import jax
import jax.numpy as jnp

from repro.models.lm import transformer as jtf
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
from repro_torch.kernels.ref import (check_mask, flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models.lm import transformer as tf

#: the reference's attention chunk (queries and keys)
CHUNK = 16
B, SK, D = 2, 64, 16
#: f32 against JAX's chunked attention
TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    kept = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = kept


def _inputs(seed, sq, hq, hkv, sk=SK, b=B, d=D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(dtype)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(dtype)
            for _ in range(2))
    return q, k, v, do


# ---------------------------------------------------------------------------
# the plain K7 / K8 with an offset against chunked_attention(q_pos0=...)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("traced", [False, True], ids=["static", "traced"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("sq,p", [(16, 0), (16, 16), (16, 37), (32, 32),
                                  (16, 48)],
                         ids=["first", "chunk", "ragged_offset", "half",
                              "last"])
def test_plain_offset_matches_chunked_attention(sq, p, hq, hkv, traced):
    """``o`` and, through ``flash_attention_plain``'s autograd and through
    ``flash_attention_bwd_ref`` on the forward's ``lse``, ``dq``, ``dk``,
    ``dv`` against the reference at ``q_pos0 = p`` (``traced``: a
    ``jnp`` scalar, the sequence-parallel shards' form); the keys no query
    sees get 0."""
    q, k, v, do = _inputs(sq * 1000 + p + hq, sq, hq, hkv)
    pos = jnp.asarray(p, jnp.int32) if traced else p
    want_o, vjp = jax.vjp(lambda q, k, v: jtf.chunked_attention(
        q, k, v, causal=True, q_chunk=CHUNK, k_chunk=CHUNK, q_pos0=pos),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention_plain(tq, tk, tv, True, None, p)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               rtol=TOL, atol=TOL)
    o.backward(torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=f"autograd {name}")
    flat = [ops._bhsd(torch.from_numpy(x)) for x in (q, k, v, do)]
    fo, lse = flash_attention_ref(*flat[:3], causal=True, q_pos0=p)
    got = flash_attention_bwd_ref(*flat[:3], fo, lse, flat[3], causal=True,
                                  q_pos0=p)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(ops._unbhsd(g, B).numpy(), w, rtol=TOL,
                                   atol=TOL, err_msg=f"written out {name}")
    for g in got[1:]:
        assert not g[:, p + sq:].any()


def test_offset_zero_is_causal_self_attention():
    """``q_pos0 = 0`` at ``Sk = Sq`` is the causal attention of before, bit
    for bit, forward and backward."""
    q, k, v, do = (ops._bhsd(torch.from_numpy(x))
                   for x in _inputs(3, 48, 6, 2, sk=48))
    o, lse = flash_attention_ref(q, k, v)
    o0, lse0 = flash_attention_ref(q, k, v, causal=True, q_pos0=0)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    for a, b in zip(flash_attention_bwd_ref(q, k, v, o, lse, do),
                    flash_attention_bwd_ref(q, k, v, o, lse, do, q_pos0=0)):
        assert torch.equal(a, b)


def test_offset_kernel_path_gradcheck_f64(monkeypatch):
    """``ops.flash_attention`` on its kernel path with an offset: the
    ``autograd.Function`` hands ``q_pos0`` to both launches (swapped for
    the plain versions) and passes ``gradcheck`` in f64."""
    calls = []

    def fake_fwd(q, k, v, *, causal, window, q_pos0=0):
        calls.append(("fwd", q_pos0))
        with torch.no_grad():
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_pos0=q_pos0)

    def fake_bwd(q, k, v, o, lse, do, *, causal, window, q_pos0=0):
        calls.append(("bwd", q_pos0))
        with torch.no_grad():
            return flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           q_pos0=q_pos0)

    monkeypatch.setattr(ops, "_use_kernel", lambda *ts: True)
    monkeypatch.setattr(ops, "flash_fwd", fake_fwd)
    monkeypatch.setattr(ops, "flash_bwd", fake_bwd)
    g = torch.Generator().manual_seed(4)
    q = torch.randn((1, 3, 4, 8), generator=g, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn((1, 9, 2, 8), generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, True, None, 5),
        (q, k, v))
    assert ("fwd", 5) in calls and ("bwd", 5) in calls
    assert {c[1] for c in calls} == {5}


@pytest.mark.parametrize("sq,sk,causal,window,p,ok", [
    (6, 9, True, None, 3, True),       # the last shard: 3 + 6 = 9 keys
    (6, 9, True, None, 0, True),       # the first shard of a split
    (6, 6, True, None, 0, True),       # causal self-attention
    (6, 9, False, None, 0, True),      # cross-attention
    (6, 9, True, None, 4, False),      # past the keys
    (6, 5, True, None, 0, False),      # fewer keys than causal queries
    (6, 9, False, None, 2, False),     # an offset without the causal mask
    (6, 9, True, None, -1, False),     # a negative offset
    (6, 6, True, 3, 0, True),          # a window on the queries' own keys
    (6, 9, True, 3, 3, False),         # a window with an offset
    (6, 9, False, 3, 0, False),        # a window over a key length of its own
])
def test_offset_rule(sq, sk, causal, window, p, ok):
    """Which mask arguments K7 / K8 and their plain versions take: both
    wrappers and both plain versions raise ``ValueError`` before any work
    for the calls ``ref.check_mask`` refuses, and run the others."""
    q, do = torch.zeros((2, sq, 16)), torch.zeros((2, sq, 16))
    k, v = torch.zeros((1, sk, 16)), torch.zeros((1, sk, 16))
    lse = torch.zeros((2, sq))
    calls = [lambda: check_mask(sq, sk, causal, window, p),
             lambda: flash_fwd(q, k, v, causal=causal, window=window,
                               q_pos0=p),
             lambda: flash_bwd(q, k, v, q, lse, do, causal=causal,
                               window=window, q_pos0=p),
             lambda: flash_attention_ref(q, k, v, causal=causal,
                                         window=window, q_pos0=p),
             lambda: flash_attention_bwd_ref(q, k, v, q, lse, do,
                                             causal=causal, window=window,
                                             q_pos0=p)]
    for call in calls:
        if ok:
            call()
        else:
            with pytest.raises(ValueError):
                call()


# ---------------------------------------------------------------------------
# seqpar_shard replayed rank by rank
# ---------------------------------------------------------------------------

def _shape_only_mesh(model: int, data: int = 1):
    """What ``seqpar_attention`` reads of a mesh before it needs a rank:
    its axes and shape."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros((data, model)))


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2)], ids=["mha", "gqa"])
def test_shards_replay_whole_attention(m, hq, hkv):
    """Rank ``i`` of ``m``'s part, for each ``i`` on one device: the
    outputs concatenated along the sequence equal whole causal attention,
    and each input's gradient summed over the shards (what the group's
    ``copy_to_group`` sums) equals the whole attention's."""
    s = 64
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(m + hq, s, hq, hkv,
                                                          sk=s))
    shard = s // m
    qw, kw, vw = (t.clone().requires_grad_() for t in (q, k, v))
    whole = ops.flash_attention_plain(qw, kw, vw, True)
    whole.backward(do)
    outs, grads = [], [torch.zeros_like(t) for t in (q, k, v)]
    for i in range(m):
        qi, ki, vi = (t.clone().requires_grad_() for t in (q, k, v))
        rows = slice(i * shard, (i + 1) * shard)
        o = tf.seqpar_shard(qi[:, rows], ki, vi, i, shard,
                            use_kernels=False)
        o.backward(do[:, rows])
        outs.append(o.detach())
        for acc, t in zip(grads, (qi, ki, vi)):
            acc += t.grad
        assert not ki.grad[:, (i + 1) * shard:].any()
    assert torch.equal(torch.cat(outs, 1), whole.detach())
    for name, g, t in zip(("dq", "dk", "dv"), grads, (qw, kw, vw)):
        top = t.grad.abs().max().item()
        torch.testing.assert_close(g, t.grad, rtol=0, atol=1e-6 * top,
                                   msg=name)


@pytest.mark.parametrize("model,s", [(1, 32), (2, 31), (4, 30)],
                         ids=["model1", "odd", "indivisible"])
def test_seqpar_falls_back_to_whole_attention(model, s):
    """A model axis of 1, or a sequence the axis does not divide, takes
    whole causal attention (the reference's fallback), bit for bit; no
    rank or group is asked for."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(s, s, 6, 2, sk=s))
    got = tf.seqpar_attention(q, k, v, _shape_only_mesh(model),
                              use_kernels=False)
    assert torch.equal(got, ops.flash_attention_plain(q, k, v, True))
