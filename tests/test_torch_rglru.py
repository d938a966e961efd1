"""The port's recurrentgemma (RG-LRU + local attention) against the JAX
package's, on the CPU.

Seeded numpy inputs go through both packages, the model reduced by
``reduce_for_smoke`` (5 layers: the ``rglru, rglru, local_attn`` period
and a 2-layer rglru tail; d 64, window 8) and built from one JAX ``init``
(``PRNGKey(0)``) carried across by ``convert.lm_params_from_flat``:

* ``_causal_conv`` with and without a carry, ``rglru_apply`` in prefill
  and one decode step from the prefill's state (state included), and the
  log-depth ``linear_scan`` against a sequential loop;
* ``attn_apply`` with a window (prefill) and ``_rolling_decode`` before
  and after the rolling buffer fills;
* ``prefill`` in the hybrid and replicated embedding modes, and a
  ``decode_step`` replay of 32 tokens (4 x the window, so the rolling
  buffer wraps) against JAX's steps and the port's own prefill;
* ``train_loss`` and every gradient (``jax.value_and_grad``);
* ``lm_params_to_flat`` of the port's tree gives the JAX init back;
* ``python -m repro_torch.launch.train --arch recurrentgemma-9b --smoke
  --device cpu``: the loss falls over 5 steps and no kernel launches.

Tolerances: f32 within 1e-5 (1e-5 relative for the loss), bf16 logits
within 5e-2 x max |logit|. Sequence lengths are multiples of the JAX
attention chunk (8): at a ragged length the reference's
``chunked_attention`` reads the wrong keys (ROADMAP queue 3). TF32 is
pinned off (it only matters on a card).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from repro.configs.registry import LM_ARCHS as J_ARCHS
from repro.configs.registry import reduce_for_smoke as j_reduce
from repro.launch.mesh import make_test_mesh
from repro.models.lm import rglru as jrg
from repro.models.lm import transformer as jtf
from repro.models.lm.backbone import LMModel as JLMModel

from repro_torch import convert
from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.kernels import _build
from repro_torch.launch import train as launch
from repro_torch.models.lm import rglru as rg
from repro_torch.models.lm import transformer as tf
from repro_torch.models.lm.backbone import LMModel
from repro_torch.tree import flatten

ARCH = "recurrentgemma-9b"
CHUNK = 8
S = 16
HOT = 0.1
F32 = 1e-5
BF16_REL = 5e-2


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _cfgs(dtype="f32"):
    return (dataclasses.replace(j_reduce(J_ARCHS[ARCH]), dtype=dtype),
            dataclasses.replace(reduce_for_smoke(LM_ARCHS[ARCH]),
                                dtype=dtype))


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten(tree)}


@functools.lru_cache(maxsize=None)
def _jax(mode, dtype):
    """The JAX model and its init from PRNGKey(0), with jitted prefill,
    decode_step and value_and_grad (shared across the tests)."""
    jcfg, _ = _cfgs(dtype)
    mesh = make_test_mesh((1, 1))
    with mesh:
        model = JLMModel(jcfg, mesh, embed_mode=mode, hot_fraction=HOT,
                         q_chunk=CHUNK, k_chunk=CHUNK, loss_chunk=CHUNK)
        params = model.init(jax.random.PRNGKey(0))
    return (mesh, model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step),
            jax.jit(jax.value_and_grad(model.train_loss)))


def _port(mode, dtype):
    _, _, jparams, *_ = _jax(mode, dtype)
    _, pcfg = _cfgs(dtype)
    model = LMModel(pcfg, device="cpu", embed_mode=mode, hot_fraction=HOT,
                    loss_chunk=CHUNK)
    return model, convert.lm_params_from_flat(_flat_np(jparams),
                                              device="cpu")


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


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


def _rglru_layer():
    _, _, jparams, *_ = _jax("replicated", "f32")
    return _layer(jparams["groups"]["0_rglru"]["rglru"])


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

def test_linear_scan_matches_a_sequential_loop():
    rng = np.random.default_rng(0)
    for s in (1, 2, 5, 16, 37):
        a = rng.uniform(0.5, 1.0, (2, s, 3)).astype(np.float32)
        b = rng.standard_normal((2, s, 3)).astype(np.float32)
        want, h = np.empty_like(b), np.zeros((2, 3), np.float32)
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want[:, t] = h
        got = rg.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32)


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_jax(carry):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    c = rng.standard_normal((2, 3, 8)).astype(np.float32) if carry else None
    want = jrg._causal_conv(jnp.asarray(x), jnp.asarray(w),
                            None if c is None else jnp.asarray(c))
    got = rg._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          None if c is None else torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32)


@pytest.mark.parametrize("s", [2, S])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_apply_prefill_and_decode_match_jax(s, dtype):
    """Prefill (the state too: a 2-token prefill pads the conv carry) and
    one decode step from the prefill's state."""
    jcfg, pcfg = _cfgs(dtype)
    p = _rglru_layer()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, s + 1, jcfg.d_model)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jo, jst = jrg.rglru_apply(_to_jax(p), jx[:, :s], jcfg)
    to, tst = rg.rglru_apply(_to_torch(p), tx[:, :s], pcfg)
    jo2, jst2 = jrg.rglru_apply(_to_jax(p), jx[:, s:], jcfg, state=jst)
    to2, tst2 = rg.rglru_apply(_to_torch(p), tx[:, s:], pcfg, state=tst)
    for got, want in ((to, jo), (to2, jo2)):
        want = np.asarray(want.astype(jnp.float32))
        tol = F32 if dtype == "f32" else BF16_REL * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol)
    for st, jst_ in ((tst, jst), (tst2, jst2)):
        assert st["h"].dtype == st["conv"].dtype == torch.float32
        for k in ("h", "conv"):
            want = np.asarray(jst_[k])
            tol = F32 if dtype == "f32" else BF16_REL * np.abs(want).max()
            np.testing.assert_allclose(st[k].numpy(), want, rtol=0,
                                       atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# local attention
# ---------------------------------------------------------------------------

def _attn_layer():
    _, _, jparams, *_ = _jax("replicated", "f32")
    return _layer(jparams["groups"]["2_local_attn"]["attn"])


def test_windowed_attn_apply_matches_jax():
    jcfg, pcfg = _cfgs()
    p = _attn_layer()
    x = np.random.default_rng(3).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    want, _ = jtf.attn_apply(_to_jax(p), jnp.asarray(x), jcfg,
                             positions=jnp.asarray(pos),
                             window=jcfg.local_attn_window,
                             q_chunk=CHUNK, k_chunk=CHUNK)
    got, _ = tf.attn_apply(_to_torch(p), torch.from_numpy(x), pcfg,
                           positions=torch.from_numpy(pos.copy()),
                           window=pcfg.local_attn_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32)


@pytest.mark.parametrize("pos", [[0, 3], [7, 8], [13, 30]],
                         ids=["filling", "full", "wrapped"])
def test_rolling_decode_matches_jax(pos):
    rng = np.random.default_rng(4)
    smax, hkv, hq, dh = 8, 1, 4, 16
    q = rng.standard_normal((2, 1, hq, dh)).astype(np.float32)
    k = rng.standard_normal((2, smax, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, smax, hkv, dh)).astype(np.float32)
    pos = np.array(pos)
    want = jtf._rolling_decode(*(jnp.asarray(a) for a in (q, k, v, pos)),
                               smax)
    got = tf._rolling_decode(*(torch.from_numpy(a) for a in (q, k, v, pos)),
                             smax)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_has_the_reference_tree():
    """The port's own init: JAX's key paths and shapes, group-major, and
    the decay parameter in the reference's range."""
    _, _, jparams, *_ = _jax("hybrid", "f32")
    _, pcfg = _cfgs()
    params = LMModel(pcfg, device="cpu", embed_mode="hybrid",
                     hot_fraction=HOT).init()
    want = {k: v.shape for k, v in _flat_np(jparams).items()}
    got = {k: tuple(v.shape) for k, v in flatten(params)}
    assert got == want
    assert list(params["groups"]) == ["0_rglru", "1_rglru", "2_local_attn",
                                      "tail0_rglru", "tail1_rglru"]
    a = torch.exp(-torch.nn.functional.softplus(
        params["groups"]["0_rglru"]["rglru"]["lam"]))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def test_params_round_trip_a_jax_init():
    _, _, jparams, *_ = _jax("hybrid", "f32")
    flat = _flat_np(jparams)
    back = convert.lm_params_to_flat(
        convert.lm_params_from_flat(flat, device="cpu"))
    assert back.keys() == flat.keys()
    for k in ("w_gelu", "w_rnn", "conv", "wa", "wx", "lam", "w_out",
              "norm/scale"):
        assert f"groups/0_rglru/rglru/{k}" in back
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("mode,dtype", [("hybrid", "f32"),
                                        ("replicated", "f32"),
                                        ("hybrid", "bf16")])
def test_prefill_matches_jax(mode, dtype):
    mesh, _, jparams, jprefill, _, _ = _jax(mode, dtype)
    tokens = _tokens(5, (2, S))
    with mesh:
        want = np.asarray(jprefill(jparams, {"tokens": jnp.asarray(tokens)}))
    model, params = _port(mode, dtype)
    got = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = F32 if dtype == "f32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_decode_replay_wraps_the_window_and_matches_jax():
    """32 tokens (4 x the window) one at a time from an empty cache into a
    ``max_seq`` 48 cache: every step's logits against JAX's step and
    the cache state after the last; the last logits against the port's
    own prefill of the same tokens."""
    mesh, jmodel, jparams, jprefill, jdecode, _ = _jax("hybrid", "f32")
    model, params = _port("hybrid", "f32")
    n, steps = 2, 32
    tokens = _tokens(6, (n, steps))
    cache = model.init_cache(n, 48)
    g = cache["groups"]
    assert g["2_local_attn"][0].shape == (1, n, 8, 1, 16)
    assert g["0_rglru"]["h"].shape == (1, n, 64)
    assert g["tail1_rglru"]["conv"].shape == (1, n, 3, 64)
    with mesh:
        jcache = jmodel.init_cache(n, 48)
        for t in range(steps):
            pos = np.full((n,), t, np.int32)
            want, jcache = jdecode(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                   jcache, jnp.asarray(pos))
            got, cache = model.decode_step(
                params, torch.from_numpy(tokens[:, t:t + 1]), cache,
                torch.from_numpy(pos))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=F32, err_msg=str(t))
    for key, jc in jcache["groups"].items():
        pc = cache["groups"][key]
        pairs = zip(jc, pc) if isinstance(jc, tuple) else \
            ((jc[k], pc[k]) for k in ("h", "conv"))
        for w, g in pairs:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=F32, err_msg=key)
    full = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-4)


def test_train_loss_and_grads_match_jax():
    mesh, _, jparams, _, _, jvg = _jax("hybrid", "f32")
    tokens = _tokens(7, (2, S))
    with mesh:
        jloss, jgrads = jvg(jparams, {"tokens": jnp.asarray(tokens)})
    model, params = _port("hybrid", "f32")
    loss, grads = launch.lm_value_and_grad(model, params,
                                           torch.from_numpy(tokens))
    assert abs(float(loss) - float(jloss)) <= F32 * abs(float(jloss))
    want, got = _flat_np(jgrads), {k: v.numpy() for k, v in flatten(grads)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=F32,
                                   err_msg=k)


def test_launcher_trains_recurrentgemma_on_cpu():
    _build.LAUNCHES.reset()
    losses = launch.main(["--arch", ARCH, "--smoke", "--steps", "5",
                          "--batch", "32", "--seq", "64", "--lr", "5",
                          "--device", "cpu", "--log-every", "1"])
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert _build.LAUNCHES.snapshot() == {}
