"""The port's encoder-decoder (seamless-m4t-large-v2) and vision-prefix
(pixtral-12b) families against the JAX package's, on the CPU.

Seeded numpy inputs go through both packages, each model reduced by
``reduce_for_smoke`` (seamless: 2 encoder and 2 decoder layers, pixtral: 2
layers; d 64, 4 query heads over 2 KV heads of 16, ``frontend_seq`` 16)
and built from one JAX ``init`` (``PRNGKey(0)``) carried across by
``convert.lm_params_from_flat``:

* the plain flash forward and backward at a key length of their own
  (``Sq != Sk``, non-causal: cross-attention) against the reference's
  ``chunked_attention(causal=False)`` and its ``jax.vjp``, and the kernel
  path's ``autograd.Function`` at ``Sq != Sk`` (f64 ``gradcheck``, the
  launches swapped for the plain versions);
* cross-attention ``attn_apply`` (``kv_from``: the shared norm, no RoPE)
  and the encoder ``_encode``;
* ``prefill``, ``train_loss`` and every gradient of both families in f32
  and bf16, the port under ``remat`` ``none``, ``full`` and ``group``
  (JAX's policies recompute the same values, so each is held against
  JAX's ``value_and_grad`` without remat: one compile per arch and dtype),
  and what each policy recomputes on the encoder-decoder (``group`` is
  ``dots`` there, as in the reference);
* ``decode_step`` against a cross cache of random values, at positions
  below and past ``frontend_seq``: the logits and the self-attention
  cache against JAX's step, the returned cross cache the one passed in,
  which the port leaves unmutated; pixtral's decode replay against JAX's;
* both packages' front doors (``launch.train`` and the
  ``lm_pretrain_smoke`` example) fail with the same ``KeyError``: their
  batches hold ``tokens`` only.

Tolerances: f32 within 1e-5 (activations), 1e-4 (logits, gradients) and
1e-5 relative (the loss); the plain attention and its gradient within
2e-4; bf16 logits and activations within 5e-2 x their largest |value|,
the bf16 loss within ``BF16_LOSS_REL``; a bf16 gradient is held by its
drift from JAX's f32 gradient, whose relative L2 error may be at most
``BF16_DRIFT`` x JAX's own bf16 gradient's plus 2e-3 (the frameworks round
bf16 at other points: on seamless each package's bf16 gradients lie 2-9%
from the f32 ones, the port's no further than JAX's). Sequence lengths are multiples of
the JAX attention chunk (8): at a ragged length the reference's
``chunked_attention`` reads the wrong keys (ROADMAP queue 3). TF32 is
pinned off (it only matters on a card).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools
import os
import runpy
import sys

import numpy as np
import jax
import jax.numpy as jnp
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import LM_ARCHS as J_ARCHS
from repro.configs.registry import reduce_for_smoke as j_reduce
from repro.launch import train as jlaunch
from repro.launch.mesh import make_test_mesh
from repro.models.lm import transformer as jtf
from repro.models.lm.backbone import LMModel as JLMModel

from repro_torch import convert
from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.examples import lm_pretrain_smoke
from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.launch import train as launch
from repro_torch.models.lm import transformer as tf
from repro_torch.models.lm.backbone import LMModel
from repro_torch.tree import flatten

SEAMLESS, PIXTRAL = "seamless-m4t-large-v2", "pixtral-12b"
ARCHS = (SEAMLESS, PIXTRAL)
CHUNK = 8
S = 16
HOT = 0.1
F32 = 1e-5
BF16_REL = 5e-2
BF16_LOSS_REL = 2e-3
BF16_DRIFT = 1.5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _cfgs(arch, dtype="f32"):
    return (dataclasses.replace(j_reduce(J_ARCHS[arch]), dtype=dtype),
            dataclasses.replace(reduce_for_smoke(LM_ARCHS[arch]),
                                dtype=dtype))


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten(tree)}


@functools.lru_cache(maxsize=None)
def _jax(arch, dtype):
    """The JAX model and its init from PRNGKey(0), with jitted prefill,
    decode_step, value_and_grad and _encode (shared across the tests)."""
    jcfg, _ = _cfgs(arch, dtype)
    mesh = make_test_mesh((1, 1))
    with mesh:
        model = JLMModel(jcfg, mesh, embed_mode="hybrid", hot_fraction=HOT,
                         q_chunk=CHUNK, k_chunk=CHUNK, loss_chunk=CHUNK)
        params = model.init(jax.random.PRNGKey(0))
    return (mesh, model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step),
            jax.jit(jax.value_and_grad(model.train_loss)),
            jax.jit(model._encode))


def _port(arch, dtype="f32", remat="none"):
    jparams = _jax(arch, dtype)[2]
    _, pcfg = _cfgs(arch, dtype)
    model = LMModel(pcfg, device="cpu", embed_mode="hybrid",
                    hot_fraction=HOT, loss_chunk=CHUNK, remat=remat)
    return model, convert.lm_params_from_flat(_flat_np(jparams),
                                              device="cpu")


def _batch(arch, seed, b=2, s=S):
    """numpy ``tokens [b, s]`` and the family's frontend input, ``frames``
    or ``patches [b, frontend_seq, d]``."""
    rng = np.random.default_rng(seed)
    cfg = _cfgs(arch)[1]
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    key = "frames" if cfg.frontend == "audio" else "patches"
    batch[key] = rng.standard_normal(
        (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _layer(tree, i=0):
    """Layer ``i`` of a stacked params tree, as numpy."""
    return {k: (_layer(v, i) if isinstance(v, dict) else np.asarray(v)[i])
            for k, v in tree.items()}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return {k: (_to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)))
            for k, v in tree.items()}


def _close(got, want, dtype, f32=F32):
    want = np.asarray(want, np.float32)
    tol = f32 if dtype == "f32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# K7 / K8's plain versions at a key length of their own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,hq,hkv", [(24, 16, 4, 2), (8, 40, 4, 4),
                                          (16, 32, 6, 1)])
def test_plain_cross_attention_matches_chunked_attention(sq, sk, hq, hkv):
    """``Sq != Sk``, non-causal: ``o`` against the reference's
    ``chunked_attention(causal=False)`` and ``dq``, ``dk``, ``dv`` against
    its ``jax.vjp``, in the model's ``[B, S, H, D]`` layout."""
    rng = np.random.default_rng(sq * 100 + sk)
    b, d = 2, 16
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
            for _ in range(2))
    want_o, vjp = jax.vjp(lambda q, k, v: jtf.chunked_attention(
        q, k, v, causal=False, q_chunk=CHUNK, k_chunk=CHUNK),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    flat = [ops._bhsd(torch.from_numpy(x)) for x in (q, k, v, do)]
    o, lse = flash_attention_ref(*flat[:3], causal=False)
    assert o.shape == (b * hq, sq, d) and lse.shape == (b * hq, sq)
    np.testing.assert_allclose(ops._unbhsd(o, b).numpy(), np.asarray(want_o),
                               rtol=0, atol=2e-4)
    got = flash_attention_bwd_ref(*flat[:3], o, lse, flat[3], causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(ops._unbhsd(g, b).numpy(), np.asarray(w),
                                   rtol=0, atol=2e-4, err_msg=name)


@pytest.fixture
def kernel_path(monkeypatch):
    """``ops.flash_attention`` on its kernel path, with K7 and K8 swapped
    for their plain versions (under ``no_grad``, as opaque to autograd as
    the kernels' output buffers); returns the launches it made with the
    key length of each."""
    calls = []

    def fake_fwd(q, k, v, *, causal, window, q_pos0=0):
        calls.append(("fwd", q.shape[1], k.shape[1]))
        assert all(t.is_contiguous() for t in (q, k, v))
        with torch.no_grad():
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_pos0=q_pos0)

    def fake_bwd(q, k, v, o, lse, do, *, causal, window, q_pos0=0):
        calls.append(("bwd", q.shape[1], k.shape[1]))
        with torch.no_grad():
            return flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           q_pos0=q_pos0)

    monkeypatch.setattr(ops, "_use_kernel", lambda *ts: True)
    monkeypatch.setattr(ops, "flash_fwd", fake_fwd)
    monkeypatch.setattr(ops, "flash_bwd", fake_bwd)
    return calls


@pytest.mark.parametrize("b", [1, 2])
def test_kernel_path_gradcheck_at_a_key_length_of_its_own(kernel_path, b):
    g = torch.Generator().manual_seed(3)
    q = torch.randn((b, 6, 4, 8), generator=g, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn((b, 10, 2, 8), generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, False), (q, k, v))
    assert ("bwd", 6, 10) in kernel_path


# ---------------------------------------------------------------------------
# cross-attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attn_apply_matches_jax(dtype):
    """Decoder layer 1's cross-attention: the queries' input and the
    encoder's output through one norm, no RoPE, 24 queries over 16 keys."""
    jcfg, pcfg = _cfgs(SEAMLESS, dtype)
    p = _layer(_jax(SEAMLESS, "f32")[2]["cross"], 1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want, _ = jtf.attn_apply(_to_jax(p), jnp.asarray(x, jdt), jcfg,
                             positions=jnp.asarray(pos), causal=False,
                             kv_from=jnp.asarray(enc, jdt))
    got, cache = tf.attn_apply(_to_torch(p), torch.from_numpy(x).to(tdt),
                               pcfg, positions=torch.from_numpy(pos.copy()),
                               causal=False,
                               kv_from=torch.from_numpy(enc).to(tdt))
    assert cache is None and got.dtype == tdt
    _close(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_matches_jax(dtype):
    mesh, _, jparams, *_, jencode = _jax(SEAMLESS, dtype)
    frames = _batch(SEAMLESS, 5)["frames"]
    with mesh:
        want = jencode(jparams, jnp.asarray(frames))
    model, params = _port(SEAMLESS, dtype)
    got = model._encode(params, torch.from_numpy(frames))
    assert got.dtype == model.cd and got.shape == frames.shape
    _close(got.float().numpy(), want.astype(jnp.float32), dtype)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree(arch):
    """The port's own init: JAX's key paths and shapes (seamless's
    ``enc_groups`` ``{attn, ffn}`` and ``cross``), and a JAX init carried
    both ways unchanged."""
    jparams = _jax(arch, "f32")[2]
    _, pcfg = _cfgs(arch)
    params = LMModel(pcfg, device="cpu", embed_mode="hybrid",
                     hot_fraction=HOT).init()
    flat = _flat_np(jparams)
    assert {k: tuple(v.shape) for k, v in flatten(params)} == \
        {k: v.shape for k, v in flat.items()}
    if arch == SEAMLESS:
        assert flat["enc_groups/attn/wq"].shape == (2, 64, 64)
        assert flat["cross/wk"].shape == (2, 64, 32)
    back = convert.lm_params_to_flat(
        convert.lm_params_from_flat(flat, device="cpu"))
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    mesh, _, jparams, jprefill, *_ = _jax(arch, dtype)
    batch = _batch(arch, 6)
    with mesh:
        want = np.asarray(jprefill(jparams, _jbatch(batch)))
    model, params = _port(arch, dtype)
    got = model.prefill(params, _tbatch(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got.numpy(), want, dtype, f32=1e-4)


@pytest.mark.parametrize("remat", ["none", "full", "group"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch, dtype, remat):
    batch = _batch(arch, 7)
    jloss, jgrads = {}, {}
    for dt in {"f32", dtype}:
        mesh, _, jparams, _, _, jvg, _ = _jax(arch, dt)
        with mesh:
            jloss[dt], jgrads[dt] = jvg(jparams, _jbatch(batch))
    jloss = float(jloss[dtype])
    model, params = _port(arch, dtype, remat)
    loss, grads = launch.lm_value_and_grad(model, params, _tbatch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    want = _flat_np(jgrads[dtype])
    exact = _flat_np(jgrads["f32"])
    got = {k: v.float().numpy() for k, v in flatten(grads)}
    assert got.keys() == want.keys()
    rel = 1e-5 if dtype == "f32" else BF16_LOSS_REL
    assert abs(float(loss) - jloss) <= rel * abs(jloss)
    for k in want:
        if dtype == "f32":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
            continue
        norm = np.linalg.norm(exact[k])
        drift = np.linalg.norm(got[k] - exact[k]) / norm
        jdrift = np.linalg.norm(want[k].astype(np.float32) - exact[k]) / norm
        assert drift <= BF16_DRIFT * jdrift + 2e-3, (k, drift, jdrift)


def test_loss_scores_the_text_positions_only():
    """pixtral's loss is the mean next-token cross-entropy of the text
    rows of the forward (the patch positions ahead of them are not
    scored): held against that cross-entropy computed by hand from the
    final hidden states."""
    model, params = _port(PIXTRAL)
    batch = _tbatch(_batch(PIXTRAL, 8))
    x, prefix = model._forward(params, batch)
    assert prefix == model.cfg.frontend_seq
    h = x[:, prefix:]
    logits = torch.cat([h @ hp for hp in model._head_parts(params)], -1)
    tokens = batch["tokens"].long()
    want = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]),
        tokens[:, 1:].reshape(-1))
    got = model.train_loss(params, batch)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


class _CountMatmuls(TorchDispatchMode):
    OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_what_each_policy_recomputes_on_the_encoder_decoder():
    """``dots`` and ``group`` both keep every matmul (the reference maps
    both to ``checkpoint_dots`` on this path), ``full`` recomputes each
    decoder layer's once; the encoder is never recomputed."""
    batch = _tbatch(_batch(SEAMLESS, 9))
    n = {}
    for remat in ("none", "dots", "full", "group"):
        model, params = _port(SEAMLESS, remat=remat)
        for _, p in flatten(params):
            p.requires_grad_(True)
        with set_checkpoint_early_stop(False):
            loss = model.train_loss(params, batch)
            with _CountMatmuls() as count:
                loss.backward()
        n[remat] = count.n
    model, params = _port(SEAMLESS)
    x = torch.zeros((2, S, model.cfg.d_model))
    enc = model._encode(params, batch["frames"])
    with _CountMatmuls() as fwd:
        model._run_encdec_decoder(params, x, torch.arange(S)[None].expand(
            2, S), enc)
    assert fwd.n > 0
    assert n["dots"] == n["group"] == n["none"]
    assert n["full"] == n["none"] + fwd.n


def test_prefill_runs_k7_at_each_key_length(kernel_path):
    """On the kernel path a seamless prefill is one K7 launch a layer of
    the encoder (16 frames over 16 keys) and two a decoder layer: the
    causal self-attention (16 over 16) and the cross-attention (16 text
    positions over the 16 encoder positions); a training step adds two
    K8 launches a forward one (``flash_bwd``'s dq and dk/dv) here counted
    once each."""
    model, params = _port(SEAMLESS)
    batch = _tbatch(_batch(SEAMLESS, 10))
    model.prefill(params, batch)
    assert kernel_path == [("fwd", 16, 16)] * 2 + [("fwd", S, 16)] * 4
    kernel_path.clear()
    launch.lm_value_and_grad(model, params, batch)
    assert [c for c in kernel_path if c[0] == "bwd"] == \
        [("bwd", S, 16)] * 4 + [("bwd", 16, 16)] * 2


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [[3, 5], [20, 20], [2, 17]],
                         ids=["inside", "past", "mixed"])
def test_encdec_decode_step_matches_jax(pos):
    """One step against a self-attention cache and a cross cache of random
    values (``frontend_seq`` 16 entries, positions below and past it): the
    logits and the self-attention cache against JAX's step; the returned
    cross cache is the one passed in, its values untouched (JAX's too)."""
    mesh, jmodel, jparams, _, jdecode, _, _ = _jax(SEAMLESS, "f32")
    model, params = _port(SEAMLESS)
    b, smax = 2, 32
    rng = np.random.default_rng(11)
    cache = model.init_cache(b, smax)
    assert cache["cross"][0].shape == (2, b, 16, 2, 16)
    fill = {}
    for name, tensors in (("self", cache["groups"]["0_attn"]),
                          ("cross", cache["cross"])):
        vals = [rng.standard_normal(tuple(t.shape)).astype(np.float32)
                for t in tensors]
        for t, v in zip(tensors, vals):
            t.copy_(torch.from_numpy(v))
        fill[name] = vals
    tokens = rng.integers(0, 512, (b, 1)).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    with mesh:
        jcache = jmodel.init_cache(b, smax)
        jcache = {"groups": {"0_attn": tuple(jnp.asarray(v)
                                             for v in fill["self"])},
                  "cross": tuple(jnp.asarray(v) for v in fill["cross"])}
        want, jnew = jdecode(jparams, jnp.asarray(tokens), jcache,
                             jnp.asarray(pos))
    cross_in = cache["cross"]
    got, new = model.decode_step(params, torch.from_numpy(tokens), cache,
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert new["cross"] is cross_in
    for t, v, jv in zip(new["cross"], fill["cross"], jnew["cross"]):
        np.testing.assert_array_equal(t.numpy(), v)
        np.testing.assert_array_equal(np.asarray(jv), v)
    for t, jv in zip(new["groups"]["0_attn"], jnew["groups"]["0_attn"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(jv), rtol=0,
                                   atol=F32)


def test_cross_decode_drops_a_write_past_the_cache():
    """The cross layer's decode (``keep_cache``) attends against a copy
    holding the token's K/V at ``pos``; at a ``pos`` past the cache the
    write is dropped, as JAX's out-of-bounds scatter drops it, and the
    token attends against the cache as it is. Neither mutates it."""
    jcfg, pcfg = _cfgs(SEAMLESS)
    p = _layer(_jax(SEAMLESS, "f32")[2]["cross"], 0)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
          for _ in range(2)]
    for pos in ([4, 15], [16, 40]):
        pos = np.asarray(pos, np.int32)
        want, _ = jtf.attn_apply(
            _to_jax(p), jnp.asarray(x), jcfg,
            positions=jnp.asarray(pos)[:, None], causal=False,
            cache=tuple(jnp.asarray(c) for c in kv),
            cache_pos=jnp.asarray(pos))
        cache = tuple(torch.from_numpy(c.copy()) for c in kv)
        got, back = tf.attn_apply(
            _to_torch(p), torch.from_numpy(x), pcfg,
            positions=torch.from_numpy(pos)[:, None], causal=False,
            cache=cache, cache_pos=torch.from_numpy(pos), keep_cache=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32)
        assert back is cache
        for t, c in zip(cache, kv):
            np.testing.assert_array_equal(t.numpy(), c)


def test_vision_decode_replay_matches_jax():
    """pixtral's decode is the dense decoder's (no patches reach it): 8
    tokens one at a time from an empty cache against JAX's steps."""
    mesh, jmodel, jparams, _, jdecode, _, _ = _jax(PIXTRAL, "f32")
    model, params = _port(PIXTRAL)
    b, steps = 2, 8
    tokens = _batch(PIXTRAL, 13, s=steps)["tokens"]
    cache = model.init_cache(b, 16)
    assert list(cache) == ["groups"]
    with mesh:
        jcache = jmodel.init_cache(b, 16)
        for t in range(steps):
            pos = np.full((b,), t, np.int32)
            want, jcache = jdecode(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                   jcache, jnp.asarray(pos))
            got, cache = model.decode_step(
                params, torch.from_numpy(tokens[:, t:t + 1]), cache,
                torch.from_numpy(pos))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4, err_msg=str(t))


def test_decode_on_cpu_launches_nothing():
    model, params = _port(SEAMLESS)
    _build.LAUNCHES.reset()
    cache = model.init_cache(2, 8)
    out, _ = model.decode_step(params, torch.zeros((2, 1), dtype=torch.long),
                               cache, torch.zeros(2, dtype=torch.long))
    assert torch.isfinite(out).all() and _build.LAUNCHES.snapshot() == {}


# ---------------------------------------------------------------------------
# the front doors
# ---------------------------------------------------------------------------

_MISSING = {SEAMLESS: "frames", PIXTRAL: "patches"}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launchers_raise_the_reference_keyerror(arch, monkeypatch):
    """The reference's LM branch feeds ``{"tokens": ...}`` only; both
    launchers fail on the frontend's input at the first step."""
    argv = ["--arch", arch, "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "8"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    with pytest.raises(KeyError) as want:
        jlaunch.main()
    with pytest.raises(KeyError) as got:
        launch.main([*argv, "--device", "cpu"])
    assert got.value.args == want.value.args == (_MISSING[arch],)


@pytest.mark.parametrize("arch", ARCHS)
def test_pretrain_examples_raise_the_reference_keyerror(arch, monkeypatch):
    argv = ["--arch", arch, "--steps", "1"]
    monkeypatch.setattr(sys, "argv", ["lm_pretrain_smoke", *argv])
    with pytest.raises(KeyError) as want:
        runpy.run_path(os.path.join(ROOT, "examples", "lm_pretrain_smoke.py"),
                       run_name="__main__")
    with pytest.raises(KeyError) as got:
        lm_pretrain_smoke.main(["--device", "cpu", *argv])
    assert got.value.args == want.value.args == (_MISSING[arch],)

