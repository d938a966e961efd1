"""The port's xLSTM (mLSTM and sLSTM blocks) against the JAX package's, on
the CPU.

Seeded numpy inputs go through both packages, the model reduced by
``reduce_for_smoke`` (4 layers: two ``mlstm, slstm`` periods; d 64, 4
heads of 16) and built from one JAX ``init`` (``PRNGKey(0)``) carried
across by ``convert.lm_params_from_flat``:

* ``mlstm_apply`` and ``slstm_apply`` in f32: a prefill from the zero
  state, then a continuation (one step, as decode, and three) from the
  state it returned: outputs and every state leaf within 1e-4;
* ``LMModel.prefill`` and a ``decode_step`` replay: f32 within 1e-4, the
  decode states too; bf16 within 5e-2 x the largest |logit| (the bound
  ``tests/test_torch_rglru.py`` holds the other recurrent family to);
* ``train_loss`` and every gradient against ``jax.value_and_grad``: f32
  within 1e-4 relative to each gradient's largest entry;
* the port's decode against its own prefill, with the bounds of
  ``tests/test_models_smoke.py::test_decode_matches_prefill``;
* every remat policy: the same loss and gradients as ``none``;
* a CPU forward launches no kernel, and the default device is ``cuda``.

TF32 is pinned off (it only matters on a card).
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
from repro.models.lm import xlstm as jxl
from repro.models.lm.backbone import LMModel as JLMModel

from repro_torch import convert
from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.kernels import _build
from repro_torch.launch import train as launch
from repro_torch.models.lm import xlstm as xl
from repro_torch.models.lm.backbone import REMATS, LMModel
from repro_torch.tree import flatten

ARCH = "xlstm-125m"
S = 16
F32 = 1e-4
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
def _jax(dtype):
    """The JAX model, its init from PRNGKey(0), and jitted prefill,
    decode_step and value_and_grad (shared across the tests)."""
    jcfg, _ = _cfgs(dtype)
    mesh = make_test_mesh((1, 1))
    with mesh:
        model = JLMModel(jcfg, mesh, embed_mode="replicated", loss_chunk=8)
        params = model.init(jax.random.PRNGKey(0))
    return (mesh, model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step),
            jax.jit(jax.value_and_grad(model.train_loss)))


def _port(dtype, **kw):
    _, _, jparams, *_ = _jax(dtype)
    _, pcfg = _cfgs(dtype)
    model = LMModel(pcfg, device="cpu", embed_mode="replicated",
                    loss_chunk=8, **kw)
    return model, convert.lm_params_from_flat(_flat_np(jparams),
                                              device="cpu")


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _to_torch(tree):
    return {k: (_to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)))
            for k, v in tree.items()}


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=F32, err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail", [1, 3])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_continuation_match_jax(kind, tail):
    jcfg, pcfg = _cfgs()
    _, _, jparams, *_ = _jax("f32")
    p = jax.tree.map(lambda a: np.asarray(a)[0],
                     jparams["groups"][f"{'01'[kind == 'slstm']}_{kind}"]
                     [kind])
    japply = jax.jit(functools.partial(
        jxl.mlstm_apply if kind == "mlstm" else jxl.slstm_apply, cfg=jcfg))
    apply = xl.mlstm_apply if kind == "mlstm" else xl.slstm_apply
    x = np.random.default_rng(2).standard_normal(
        (2, S + tail, jcfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), _to_torch(p)
    jo, jst = japply(jp, jnp.asarray(x[:, :S]))
    to, tst = apply(tp, torch.from_numpy(x[:, :S]), pcfg)
    jo2, jst2 = japply(jp, jnp.asarray(x[:, S:]), state=jst)
    to2, tst2 = apply(tp, torch.from_numpy(x[:, S:]), pcfg, state=tst)
    for got, want in ((to, jo), (to2, jo2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32)
    for st, jst_ in ((tst, jst), (tst2, jst2)):
        assert st.keys() == jst_.keys()
        assert all(v.dtype == torch.float32 for v in st.values())
        _close(st, jst_, kind)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_has_the_reference_tree():
    _, _, jparams, *_ = _jax("f32")
    model, _ = _port("f32")
    own = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in flatten(own)} == \
        {k: v.shape for k, v in _flat_np(jparams).items()}
    assert list(own["groups"]) == ["0_mlstm", "1_slstm"]
    assert float(own["groups"]["0_mlstm"]["mlstm"]["bf"].min()) == 3.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(dtype):
    mesh, jmodel, jparams, jprefill, jdecode, _ = _jax(dtype)
    model, params = _port(dtype)
    tokens = _tokens(3, (2, S))
    with mesh:
        want = np.asarray(jprefill(jparams, {"tokens": jnp.asarray(tokens)}))
    got = model.prefill(params, {"tokens": torch.from_numpy(tokens)}).numpy()
    tol = F32 if dtype == "f32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    b, steps = 2, 5
    jcache, cache = jmodel.init_cache(b, 8), model.init_cache(b, 8)
    for i in range(steps):
        pos = np.full((b,), i, np.int32)
        with mesh:
            want, jcache = jdecode(jparams, jnp.asarray(tokens[:, i:i + 1]),
                                   jcache, jnp.asarray(pos))
        got, cache = model.decode_step(params,
                                       torch.from_numpy(tokens[:, i:i + 1]),
                                       cache, torch.from_numpy(pos))
        want = np.asarray(want)
        tol = F32 if dtype == "f32" else BF16_REL * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if dtype == "f32":
        for key, jst in jcache["groups"].items():
            _close(cache["groups"][key], jst, key)


def test_train_loss_and_grads_match_jax():
    mesh, _, jparams, _, _, jvg = _jax("f32")
    tokens = _tokens(4, (2, S))
    with mesh:
        jloss, jgrads = jvg(jparams, {"tokens": jnp.asarray(tokens)})
    model, params = _port("f32")
    loss, grads = launch.lm_value_and_grad(model, params,
                                           torch.from_numpy(tokens))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want, got = _flat_np(jgrads), {k: v.numpy() for k, v in flatten(grads)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_decode_matches_prefill():
    """Token-by-token decode == full prefill in the port (bf16), with the
    reference's own bounds for the same check."""
    model = LMModel(reduce_for_smoke(LM_ARCHS[ARCH]), device="cpu",
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


def test_remat_policies_match_none():
    tokens = torch.from_numpy(_tokens(6, (2, S)))
    base_loss, base = None, None
    for remat in REMATS:
        model, params = _port("f32", remat=remat)
        loss, grads = launch.lm_value_and_grad(model, params, tokens)
        if base is None:
            base_loss, base = float(loss), flatten(grads)
            continue
        assert abs(float(loss) - base_loss) <= 1e-6 * abs(base_loss), remat
        for (k, g), (_, w) in zip(flatten(grads), base):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6,
                                       msg=f"{remat} {k}")


def test_cpu_prefill_launches_nothing_and_the_default_is_cuda():
    model = LMModel(reduce_for_smoke(LM_ARCHS[ARCH]), device="cpu")
    params = model.init()
    _build.LAUNCHES.reset()
    out = model.prefill(params, {"tokens": torch.from_numpy(
        _tokens(2, (2, 5)))})
    assert out.shape == (2, model.logits_size) and torch.isfinite(out).all()
    assert _build.LAUNCHES.snapshot() == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LMModel(reduce_for_smoke(LM_ARCHS[ARCH]))
