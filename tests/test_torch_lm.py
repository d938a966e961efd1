"""The port's dense-LM serving path against the JAX package's, on the CPU.

Seeded numpy inputs go through both packages:

* the plain flash-attention forward (K7's plain version, ``o`` and
  ``lse``) against the Pallas ``flash_fwd`` in interpret mode, for MHA,
  GQA and MQA, causal, non-causal and a 24-key window: f32 <= 2e-4, bf16
  <= 5e-2 (the Pallas kernel rounds ``p`` to bf16 before the PV product,
  the plain version keeps it f32); at an odd S, where the Pallas kernel's
  blocks do not divide S, against the reference's ``flash_attention_ref``;
* the norms, RoPE and the FFN with every activation: f32 <= 1e-5;
* ``LMModel.prefill`` of the four dense archs reduced by
  ``reduce_for_smoke``, in every embedding mode at S = 8 and 24, from one
  JAX-exported ``init`` (``convert.lm_params_from_flat``): f32 <= 1e-4;
  bf16 within ``BF16_LOGIT_TOL`` (the frameworks round bf16 at other
  points: matmul accumulation and elementwise ops);
* ``decode_step`` over a few steps, logits and KV cache: f32 <= 1e-4;
* the port's decode against its own prefill, with the bounds of
  ``tests/test_models_smoke.py::test_decode_matches_prefill``.

TF32 is pinned off for every test (it only matters on a card).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp

from repro.configs.registry import LM_ARCHS as J_ARCHS
from repro.configs.registry import reduce_for_smoke as j_reduce
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.launch.mesh import make_test_mesh
from repro.models.lm import transformer as jtf
from repro.models.lm.backbone import LMModel as JLMModel

from repro_torch import convert
from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_fwd
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models.lm import transformer as tf
from repro_torch.models.lm.backbone import LMModel
from repro_torch.tree import flatten

DENSE = ("phi3-mini-3.8b", "minitron-4b", "command-r-plus-104b", "olmo-1b")
MODES = ("replicated", "sharded", "hybrid")
HOT = 0.1
#: bf16 prefill logits, port against JAX: ~6 bf16 ulps at |logit| in
#: [2, 4) (observed: 2 ulps)
BF16_LOGIT_TOL = 0.1


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _cfgs(arch, dtype):
    return (dataclasses.replace(j_reduce(J_ARCHS[arch]), dtype=dtype),
            dataclasses.replace(reduce_for_smoke(LM_ARCHS[arch]),
                                dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax(arch, mode, dtype):
    """The JAX model, its init from PRNGKey(0), and jitted prefill and
    decode_step (shared across the tests of one arch, mode and dtype)."""
    jcfg, _ = _cfgs(arch, dtype)
    mesh = make_test_mesh((1, 1))
    with mesh:
        model = JLMModel(jcfg, mesh, embed_mode=mode, hot_fraction=HOT,
                         q_chunk=8, k_chunk=8)
        params = model.init(jax.random.PRNGKey(0))
    return (mesh, model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step))


def _port(arch, mode, dtype):
    _, _, jparams, _, _ = _jax(arch, mode, dtype)
    _, pcfg = _cfgs(arch, dtype)
    model = LMModel(pcfg, device="cpu", embed_mode=mode, hot_fraction=HOT)
    flat = {k: np.asarray(v) for k, v in flatten(jparams)}
    return model, convert.lm_params_from_flat(flat, device="cpu")


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# K7's plain version
# ---------------------------------------------------------------------------

def _qkv(rng, bh, bkv, s, d, dtype):
    q, k, v = (rng.standard_normal((n, s, d)).astype(np.float32)
               for n in (bh, bkv, bkv))
    return ((q, k, v) if dtype == "f32" else
            tuple(np.array(jnp.asarray(x, jnp.bfloat16).astype(
                jnp.float32)) for x in (q, k, v)))


def _as(x, dtype):
    t = torch.from_numpy(x)
    return t if dtype == "f32" else t.to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 24)],
                         ids=["causal", "full", "window24"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2), (8, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_flash_plain_matches_pallas(hq, hkv, causal, window, dtype):
    b, s, d = 2, 48, 16
    rng = np.random.default_rng(hq * 10 + hkv)
    q, k, v = _qkv(rng, b * hq, b * hkv, s, d, dtype)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jo, jl = jfa.flash_fwd(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                           causal=causal, window=window, block_q=16,
                           block_k=16, interpret=True)
    o, lse = flash_fwd(*(_as(x, dtype) for x in (q, k, v)), causal=causal,
                       window=window)
    tol = 2e-4 if dtype == "f32" else 5e-2
    assert o.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert lse.dtype == torch.float32 and lse.shape == (b * hq, s)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 7)],
                         ids=["causal", "full", "window7"])
def test_flash_plain_odd_length_matches_reference(causal, window):
    """S = 37 fits no Pallas block; the plain version against the
    reference's oracle (``o`` only; it returns no lse) in the model's
    ``[B, S, H, D]`` layout."""
    rng = np.random.default_rng(37)
    b, s, hq, hkv, d = 2, 37, 6, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, window))
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


def test_flash_wrapper_checks_shapes():
    q = torch.zeros((6, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_fwd(q, torch.zeros((4, 8, 16)), torch.zeros((4, 8, 16)))
    with pytest.raises(ValueError, match="window"):
        flash_fwd(q, torch.zeros((2, 8, 16)), torch.zeros((2, 8, 16)),
                  window=0)
    with pytest.raises(ValueError):
        flash_fwd(q, torch.zeros((2, 8, 16)), torch.zeros((2, 8, 16),
                                                          device="meta"))


def test_flash_attention_cpu_is_differentiable():
    """On CPU tensors ``ops.flash_attention`` is the plain version in plain
    torch ops, so autograd differentiates it (f64 gradcheck)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 5, 4, 8), generator=g, dtype=torch.float64,
                    requires_grad=True)
    k = torch.randn((1, 5, 2, 8), generator=g, dtype=torch.float64,
                    requires_grad=True)
    v = torch.randn((1, 5, 2, 8), generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, True, None), (q, k, v))


def test_flash_attention_kernel_path_backward_raises(monkeypatch):
    """On the kernel path the output comes from K7 through an
    ``autograd.Function`` whose backward is K8; it raises nothing now, and
    its gradients are autograd's of the plain version. Both launches are
    swapped for their plain versions (under ``no_grad``, as opaque to
    autograd as the kernels' output buffers) so the path runs here."""
    calls = []

    def fake_flash_fwd(q, k, v, *, causal, window, q_pos0=0):
        calls.append(("fwd", q.shape))
        with torch.no_grad():
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_pos0=q_pos0)

    def fake_flash_bwd(q, k, v, o, lse, do, *, causal, window, q_pos0=0):
        calls.append(("bwd", do.shape))
        with torch.no_grad():
            return flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           q_pos0=q_pos0)

    monkeypatch.setattr(ops, "_use_kernel", lambda *ts: True)
    monkeypatch.setattr(ops, "flash_fwd", fake_flash_fwd)
    monkeypatch.setattr(ops, "flash_bwd", fake_flash_bwd)
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 9, 6, 16), generator=g, requires_grad=True)
    k = torch.randn((2, 9, 2, 16), generator=g, requires_grad=True)
    v = torch.randn((2, 9, 2, 16), generator=g, requires_grad=True)
    do = torch.randn((2, 9, 6, 16), generator=g)
    o = ops.flash_attention(q, k, v, True, None)
    want = ops.flash_attention_plain(q, k, v)
    torch.testing.assert_close(o, want, rtol=0, atol=0)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert calls == [("fwd", (12, 9, 16)), ("bwd", (12, 9, 16))]
    for name, a, b in zip("qkv", got, torch.autograd.grad(want, (q, k, v),
                                                          do)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=name)


# ---------------------------------------------------------------------------
# transformer pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_jax(norm):
    cfg_j, cfg_p = _cfgs("minitron-4b", "f32")
    cfg_j = dataclasses.replace(cfg_j, norm=norm)
    cfg_p = dataclasses.replace(cfg_p, norm=norm)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    params = {} if norm == "nonparam_ln" else {
        "scale": rng.standard_normal(64).astype(np.float32)}
    want = np.asarray(jtf.norm_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        cfg_j))
    got = tf.norm_apply({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), cfg_p)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert tf.norm_init(cfg_p).keys() == jtf.norm_init(cfg_j).keys()


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    want = np.asarray(jtf.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tf.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu",
                                 "relu_sq"])
def test_ffn_matches_jax(act):
    cfg_j, cfg_p = _cfgs("phi3-mini-3.8b", "f32")
    cfg_j = dataclasses.replace(cfg_j, activation=act)
    cfg_p = dataclasses.replace(cfg_p, activation=act)
    params = jtf.ffn_init(jax.random.PRNGKey(5), cfg_j)
    x = np.random.default_rng(5).standard_normal((2, 6, 64)).astype(
        np.float32)
    want = np.asarray(jtf.ffn_apply(params, jnp.asarray(x), cfg_j))
    got = tf.ffn_apply(convert.lm_params_from_flat(
        {k: np.asarray(v) for k, v in flatten(params)}, device="cpu"),
        torch.from_numpy(x), cfg_p)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    shapes = {k: tuple(v.shape) for k, v in flatten(tf.ffn_init(
        torch.Generator().manual_seed(0), cfg_p))}
    assert shapes == {k: tuple(v.shape) for k, v in flatten(params)}


# ---------------------------------------------------------------------------
# LMModel against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 24])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_jax_f32(arch, mode, s):
    mesh, jmodel, jparams, jprefill, _ = _jax(arch, mode, "f32")
    tokens = _tokens(s, (2, s))
    with mesh:
        want = np.asarray(jprefill(jparams, {"tokens": jnp.asarray(tokens)}))
    model, params = _port(arch, mode, "f32")
    assert model.logits_size == jmodel.logits_size
    assert (model.hot_rows, model.cold_rows) == (jmodel.hot_rows,
                                                 jmodel.cold_rows)
    got = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_jax_bf16(arch, mode):
    mesh, _, jparams, jprefill, _ = _jax(arch, mode, "bf16")
    tokens = _tokens(24, (2, 24))
    with mesh:
        want = np.asarray(jprefill(jparams, {"tokens": jnp.asarray(tokens)}))
    model, params = _port(arch, mode, "bf16")
    got = model.prefill(params, {"tokens": torch.from_numpy(tokens)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_TOL)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_jax_f32(arch, mode):
    mesh, jmodel, jparams, _, jdecode = _jax(arch, mode, "f32")
    model, params = _port(arch, mode, "f32")
    b, smax, steps = 2, 8, 3
    tokens = _tokens(7, (b, steps))
    jcache = jmodel.init_cache(b, smax)
    cache = model.init_cache(b, smax)
    for i in range(steps):
        pos = np.full((b,), i, np.int32)
        with mesh:
            want, jcache = jdecode(jparams, jnp.asarray(tokens[:, i:i + 1]),
                                   jcache, jnp.asarray(pos))
        got, cache = model.decode_step(params,
                                       torch.from_numpy(tokens[:, i:i + 1]),
                                       cache, torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
    for key, (jk, jv) in jcache["groups"].items():
        pk, pv = cache["groups"][key]
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch):
    """Token-by-token decode == full prefill in the port (bf16), with the
    reference's own bounds for the same check."""
    model = LMModel(reduce_for_smoke(LM_ARCHS[arch]), device="cpu",
                    embed_mode="replicated")
    params = model.init(torch.Generator().manual_seed(0))
    b, s = 1, 8
    tokens = torch.from_numpy(_tokens(1, (b, s)))
    full = model.prefill(params, {"tokens": tokens}).numpy()
    cache = model.init_cache(b, s)
    for i in range(s):
        logits, cache = model.decode_step(params, tokens[:, i:i + 1], cache,
                                          torch.full((b,), i))
    got = logits.numpy()
    np.testing.assert_allclose(got, full, rtol=0.1, atol=0.15)
    assert np.corrcoef(got.ravel(), full.ravel())[0, 1] > 0.99


@pytest.mark.parametrize("arch,mode", [("olmo-1b", "replicated"),
                                       ("minitron-4b", "hybrid"),
                                       ("command-r-plus-104b", "sharded")])
def test_lm_params_flat_round_trip(arch, mode):
    _, _, jparams, _, _ = _jax(arch, mode, "f32")
    flat = {k: np.asarray(v) for k, v in flatten(jparams)}
    back = convert.lm_params_to_flat(convert.lm_params_from_flat(
        flat, device="cpu"))
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])
    # the port's own init has the reference's keys and shapes
    _, pcfg = _cfgs(arch, "f32")
    own = LMModel(pcfg, device="cpu", embed_mode=mode, hot_fraction=HOT).init(
        torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in flatten(own)} == \
        {k: v.shape for k, v in flat.items()}


def test_prefill_on_cpu_launches_nothing():
    model = LMModel(reduce_for_smoke(LM_ARCHS["minitron-4b"]), device="cpu",
                    embed_mode="hybrid")
    params = model.init()
    _build.LAUNCHES.reset()
    out = model.prefill(params, {"tokens": torch.from_numpy(
        _tokens(2, (2, 5)))})
    assert out.shape == (2, model.logits_size)
    assert torch.isfinite(out).all()
    assert _build.LAUNCHES.snapshot() == {}


# ---------------------------------------------------------------------------
# what this slice leaves out
# ---------------------------------------------------------------------------

def test_left_out_paths_raise():
    """Cross-attention is held to the JAX package in
    ``tests/test_torch_encdec.py``; with a cache it is the reference's
    unreachable branch, which the port refuses. ``seqpar_attention`` at a
    model axis of 1 is whole causal attention (the reference's fallback;
    its shards are held in ``tests/test_torch_seqpar.py`` and on a mesh in
    ``tests/test_torch_lm_mesh.py``); ``chunked_attention`` has no port."""
    cfg = reduce_for_smoke(LM_ARCHS["olmo-1b"])
    params = LMModel(cfg, device="cpu").init()
    x = torch.zeros((1, 4, cfg.d_model))
    pos = torch.zeros((1, 4), dtype=torch.int64)
    blk = params["groups"]["0_attn"]
    layer = {k: v[0] for k, v in blk["attn"].items() if k != "norm"}
    kv = torch.zeros((1, 8, cfg.num_kv_heads, cfg.resolved_head_dim))
    with pytest.raises(ValueError, match="takes no cache"):
        tf.attn_apply(layer, x, cfg, positions=pos, kv_from=x, cache=(kv, kv),
                      cache_pos=pos[:, 0])
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, cfg.num_heads, cfg.resolved_head_dim),
                    generator=g)
    k, v = torch.randn((2, 1, 4, cfg.num_kv_heads, cfg.resolved_head_dim),
                       generator=g)
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                mesh=torch.zeros((2, 1)))
    assert torch.equal(tf.seqpar_attention(q, k, v, one),
                       ops.flash_attention(q, k, v, True))
    with pytest.raises(NotImplementedError, match="K7"):
        tf.chunked_attention(x, x, x)


def test_lm_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        LMModel(reduce_for_smoke(LM_ARCHS["olmo-1b"]))
