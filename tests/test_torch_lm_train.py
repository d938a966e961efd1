"""The port's dense-LM training path against the JAX package's, on the CPU.

Seeded numpy inputs go through both packages:

* (a) K8's plain version, ``flash_attention_bwd_ref``, against the Pallas
  ``flash_bwd`` in interpret mode (fed the Pallas forward's ``o`` and
  ``lse``), for MHA, GQA and MQA, causal, non-causal and a 24-key window,
  at S = 48 in blocks of 16: f32 <= 2e-4; bf16 by ``ref.BF16_GRAD_RULE``,
  within 1e-2 of the largest |gradient|, the whole gradient within 1e-2
  relative L2 and each row within 2e-2 of its own norm (the Pallas
  kernel rounds ``p`` and ``ds`` to bf16 before its products and writes
  bf16 gradients, the plain version keeps f32).
  At S = 512 that rule passes the Pallas kernel and rejects it once the
  diagonal key of each query in the last tile is dropped. At an odd S,
  which no Pallas block divides, against ``jax.vjp`` of the reference's
  ``flash_attention_ref``: f32 <= 2e-4.
* (b) the kernel path's ``autograd.Function`` (K7 forward, K8 backward)
  with both launches swapped for their plain versions: f64 ``gradcheck``.
* (c) ``LMModel.train_loss`` and its gradient for every param leaf against
  ``jax.value_and_grad`` of the JAX ``train_loss``, for the four dense
  archs reduced by ``reduce_for_smoke`` in all three embedding modes, from
  one JAX ``init`` (``convert.lm_params_from_flat``), at S = 24 in loss
  chunks of 8: f32 loss <= 1e-5 relative, gradients <= 1e-4 (observed:
  loss equal, gradients 2.7e-7); bf16 loss <= ``BF16_LOSS_REL`` relative
  and gradients <= ``BF16_GRAD_TOL`` (observed: 7.6e-4 and 4.4e-3; the
  frameworks round bf16 at other points).
* (d) three steps of ``lm_train_step`` with SGD and with AdamW against the
  same steps in JAX (``jax.jit`` of the train branch of
  ``specs.lm_step_fn``, and its SGD twin): the loss trajectory <= 1e-5
  relative, the final params <= ``TRAJ_PARAM_TOL``; the in-place SGD step
  gives ``optimizers.make("sgd")``'s values bit for bit.
* (e) ``remat="full"`` gives the loss and gradients of ``"none"``; a
  policy the reference does not have raises.
* (f) ``python -m repro_torch.launch.train --smoke --device cpu``: the loss
  falls over 5 steps and no kernel launches; ``--mode``, ``--comm``,
  ``--grad-ar-dtype`` and ``--ckpt-dir`` are taken and ignored, as the
  reference's LM branch does.

S is a multiple of the JAX attention chunk in (c) and (d): at other S the
reference's ``chunked_attention`` slices its last key chunk with a
clamped ``dynamic_slice`` and attends to the wrong keys (ROADMAP queue 3).
TF32 is pinned off for every test (it only matters on a card).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import LM_ARCHS as J_ARCHS
from repro.configs.registry import reduce_for_smoke as j_reduce
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.launch.mesh import make_test_mesh
from repro.launch.specs import lm_step_fn
from repro.models.lm.backbone import LMModel as JLMModel
from repro.optim import optimizers as joptim

from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_bwd
from repro_torch.kernels.ref import (BF16_GRAD_RULE,
                                     flash_attention_bwd_ref,
                                     flash_attention_ref, grad_row_error)
from repro_torch.launch import train as launch
from repro_torch.models.lm.backbone import LMModel
from repro_torch.optim import optimizers
from repro_torch.tree import flatten

DENSE = ("phi3-mini-3.8b", "minitron-4b", "command-r-plus-104b", "olmo-1b")
MODES = ("replicated", "sharded", "hybrid")
HOT = 0.1
S, CHUNK = 24, 8
#: bf16 train_loss, port against JAX: relative loss, absolute gradients
BF16_LOSS_REL = 2e-3
BF16_GRAD_TOL = 2e-2
#: final params after three f32 steps, port against JAX
TRAJ_PARAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten(tree)}


def _flat_torch(tree):
    return {k: v.detach().float().numpy() for k, v in flatten(tree)}


# ---------------------------------------------------------------------------
# (a) K8's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 24)],
                         ids=["causal", "full", "window24"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2), (8, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_flash_bwd_plain_matches_pallas(hq, hkv, causal, window, dtype):
    b, s, d = 2, 48, 16
    rng = np.random.default_rng(hq * 10 + hkv)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(rng.standard_normal((n, s, d)), jdt)
                       for n in (b * hq, b * hkv, b * hkv, b * hq))
    blocks = dict(causal=causal, window=window, block_q=16, block_k=16,
                  interpret=True)
    jo, jl = jfa.flash_fwd(jq, jk, jv, **blocks)
    want = jfa.flash_bwd(jq, jk, jv, jo, jl, jdo, **blocks)
    as_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        tdt)
    got = flash_attention_bwd_ref(*(as_t(x) for x in (jq, jk, jv, jo)),
                                  torch.from_numpy(np.array(jl)), as_t(jdo),
                                  causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.array(w.astype(jnp.float32))
        assert g.dtype == tdt and g.shape == w.shape, name
        if dtype == "f32":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4,
                                       err_msg=name)
            continue
        peak, whole, worst = grad_row_error(g, torch.from_numpy(w))
        assert peak <= BF16_GRAD_RULE["peak"], (name, peak)
        assert whole <= BF16_GRAD_RULE["whole"], (name, whole)
        assert worst <= 1.0, (name, worst)


def test_bf16_grad_rule_rejects_a_fault_in_the_last_tile():
    """Causal gradients shrink along the sequence, so a limit taken from
    the largest |gradient| hides a fault in the later rows. The row rule
    passes the Pallas kernel's bf16 gradients and fails them once the
    diagonal key of each query in the last 64 is dropped (its ``p`` and
    ``ds`` terms taken out of ``dq``, ``dk`` and ``dv``)."""
    s, d, hq, hkv = 512, 32, 3, 1
    rng = np.random.default_rng(5)
    jq, jk, jv, jdo = (jnp.asarray(rng.standard_normal((n, s, d)),
                                   jnp.bfloat16) for n in (hq, hkv, hkv, hq))
    blocks = dict(causal=True, window=None, block_q=64, block_k=64,
                  interpret=True)
    jo, jl = jfa.flash_fwd(jq, jk, jv, **blocks)
    as_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))
    pallas = [as_t(x) for x in jfa.flash_bwd(jq, jk, jv, jo, jl, jdo,
                                              **blocks)]
    q, k, v, o, do = (as_t(x) for x in (jq, jk, jv, jo, jdo))
    lse = torch.from_numpy(np.array(jl))
    want = flash_attention_bwd_ref(*(x.bfloat16() for x in (q, k, v, o)),
                                   lse, do.bfloat16(), causal=True)
    scale = d ** -0.5
    late = (torch.arange(s) >= s - 64)[:, None]
    p = torch.exp((q * k).sum(-1, keepdim=True) * scale - lse[..., None])
    ds = p * ((do * v).sum(-1, keepdim=True)
              - (do * o).sum(-1, keepdim=True)) * scale
    p, ds = (torch.where(late, x, 0.0) for x in (p, ds))
    faulty = (pallas[0] - ds * k, pallas[1] - (ds * q).sum(0, keepdim=True),
              pallas[2] - (p * do).sum(0, keepdim=True))
    for name, good, bad, w in zip(("dq", "dk", "dv"), pallas, faulty, want):
        peak, whole, worst = grad_row_error(good, w)
        assert peak <= BF16_GRAD_RULE["peak"], name
        assert whole <= BF16_GRAD_RULE["whole"] and worst <= 1.0, name
        assert grad_row_error(bad, w)[2] > 1.0, name


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 7)],
                         ids=["causal", "full", "window7"])
def test_flash_bwd_plain_odd_length_matches_jax_vjp(causal, window):
    """S = 37 fits no Pallas block: the plain forward and backward against
    ``jax.vjp`` of the reference's oracle, in the model's ``[B, S, H, D]``
    layout."""
    rng = np.random.default_rng(37)
    b, s, hq, hkv, d = 2, 37, 6, 2, 16
    q, do = (rng.standard_normal((b, s, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal, window), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    flat = [ops._bhsd(torch.from_numpy(x)) for x in (q, k, v, do)]
    o, lse = flash_attention_ref(*flat[:3], causal=causal, window=window)
    got = flash_attention_bwd_ref(*flat[:3], o, lse, flat[3], causal=causal,
                                  window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(ops._unbhsd(g, b).numpy(), np.asarray(w),
                                   rtol=0, atol=2e-4, err_msg=name)


# ---------------------------------------------------------------------------
# (b) the kernel path's autograd.Function
# ---------------------------------------------------------------------------

@pytest.fixture
def kernel_path(monkeypatch):
    """``ops.flash_attention`` on its kernel path, with K7 and K8 swapped
    for their plain versions (under ``no_grad``, as opaque to autograd as
    the kernels' output buffers); returns the launches it made."""
    calls = []

    def fake_fwd(q, k, v, *, causal, window, q_pos0=0):
        calls.append("fwd")
        assert all(t.is_contiguous() for t in (q, k, v))
        with torch.no_grad():
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_pos0=q_pos0)

    def fake_bwd(q, k, v, o, lse, do, *, causal, window, q_pos0=0):
        calls.append("bwd")
        assert all(t.is_contiguous() for t in (q, k, v, o, lse, do))
        with torch.no_grad():
            return flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           q_pos0=q_pos0)

    monkeypatch.setattr(ops, "_use_kernel", lambda *ts: True)
    monkeypatch.setattr(ops, "flash_fwd", fake_fwd)
    monkeypatch.setattr(ops, "flash_bwd", fake_bwd)
    return calls


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 3)],
                         ids=["causal", "full", "window3"])
@pytest.mark.parametrize("b", [1, 2])
def test_flash_attention_kernel_path_gradcheck_f64(kernel_path, causal,
                                                   window, b):
    """At B = 1 the flat layout is a strided view unless copied: the
    kernels' operands must still be contiguous."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn((b, 6, 4, 8), generator=g, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn((b, 6, 2, 8), generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal, window),
        (q, k, v))
    assert "bwd" in kernel_path


# ---------------------------------------------------------------------------
# (c) train_loss and its gradient against JAX
# ---------------------------------------------------------------------------

def _cfgs(arch, dtype):
    return (dataclasses.replace(j_reduce(J_ARCHS[arch]), dtype=dtype),
            dataclasses.replace(reduce_for_smoke(LM_ARCHS[arch]),
                                dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax(arch, mode, dtype):
    """The JAX model and its init from PRNGKey(0)."""
    jcfg, _ = _cfgs(arch, dtype)
    mesh = make_test_mesh((1, 1))
    with mesh:
        model = JLMModel(jcfg, mesh, embed_mode=mode, hot_fraction=HOT,
                         q_chunk=CHUNK, k_chunk=CHUNK, loss_chunk=CHUNK)
        params = model.init(jax.random.PRNGKey(0))
    return mesh, model, params


def _port(arch, mode, dtype, **kw):
    _, _, jparams = _jax(arch, mode, dtype)
    _, pcfg = _cfgs(arch, dtype)
    model = LMModel(pcfg, device="cpu", embed_mode=mode, hot_fraction=HOT,
                    loss_chunk=CHUNK, **kw)
    return model, convert.lm_params_from_flat(_flat_np(jparams),
                                              device="cpu")


def _tokens(seed, shape=(2, S), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_and_grads_match_jax(arch, mode, dtype):
    mesh, jmodel, jparams = _jax(arch, mode, dtype)
    tokens = _tokens(3)
    with mesh:
        jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.train_loss))(
            jparams, {"tokens": jnp.asarray(tokens)})
    model, params = _port(arch, mode, dtype)
    loss, grads = launch.lm_value_and_grad(model, params,
                                           torch.from_numpy(tokens))
    assert loss.dtype == torch.float32 and loss.shape == ()
    want, got = _flat_np(jgrads), _flat_torch(grads)
    assert got.keys() == want.keys()
    rel, tol = (1e-5, 1e-4) if dtype == "f32" else (BF16_LOSS_REL,
                                                    BF16_GRAD_TOL)
    assert abs(float(loss) - float(jloss)) <= rel * abs(float(jloss))
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k].astype(np.float32),
                                   rtol=0, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# (d) three optimizer steps against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_train_steps_match_jax(opt):
    arch, mode, steps = "minitron-4b", "hybrid", 3
    mesh, jmodel, params0 = _jax(arch, mode, "f32")
    kw = dict(learning_rate=3e-2, weight_decay=0.1)
    jtcfg = JTrainConfig(**kw)
    if opt == "adamw":
        jopt = joptim.make("adamw", jtcfg)
        jstep = lm_step_fn(jmodel, JShapeConfig("t", "train", S, 2), jtcfg)
    else:
        jopt = joptim.make("sgd", jtcfg)

        def jstep(params, opt_state, batch):
            loss, grads = jax.value_and_grad(jmodel.train_loss)(params,
                                                                batch)
            return (*jopt.update(grads, opt_state, params), loss)
    model, params = _port(arch, mode, "f32")
    popt = optimizers.make(opt, TrainConfig(**kw))
    step = launch.lm_train_step(model, popt)
    jparams, jstate, state = params0, jopt.init(params0), popt.init(params)
    with mesh:
        jstep = jax.jit(jstep)
        for i in range(steps):
            tokens = _tokens(10 + i)
            jparams, jstate, jloss = jstep(
                jparams, jstate, {"tokens": jnp.asarray(tokens)})
            params, state, loss = step(params, state,
                                       torch.from_numpy(tokens))
            assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want, got = _flat_np(jparams), _flat_torch(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=TRAJ_PARAM_TOL, err_msg=k)
    assert int(state["step"]) == steps


def test_in_place_sgd_matches_optimizer():
    model, params = _port("olmo-1b", "replicated", "f32")
    tokens = torch.from_numpy(_tokens(5))
    opt = optimizers.make("sgd", TrainConfig(learning_rate=0.1))
    want, _, want_loss = launch.lm_train_step(model, opt)(
        params, opt.init(params), tokens)
    loss = launch.lm_sgd_step_(model, params, tokens, 0.1)
    assert float(loss) == float(want_loss)
    for (k, g), (_, w) in zip(flatten(params), flatten(want)):
        assert torch.equal(g, w), k


# ---------------------------------------------------------------------------
# (e) remat
# ---------------------------------------------------------------------------

def test_remat_full_matches_none():
    tokens = torch.from_numpy(_tokens(6))
    model, params = _port("phi3-mini-3.8b", "hybrid", "f32")
    remat, _ = _port("phi3-mini-3.8b", "hybrid", "f32", remat="full")
    loss, grads = launch.lm_value_and_grad(model, params, tokens)
    rloss, rgrads = launch.lm_value_and_grad(remat, params, tokens)
    assert float(rloss) == pytest.approx(float(loss), rel=1e-6)
    for (k, g), (_, r) in zip(flatten(grads), flatten(rgrads)):
        torch.testing.assert_close(r, g, rtol=0, atol=1e-6, msg=k)


@pytest.mark.parametrize("remat", ["dot", "nested"])
def test_other_remat_policies_raise(remat):
    """Every policy of the reference is ported (``dots`` and ``group``:
    ``tests/test_torch_lm_remat.py``); a name outside them raises."""
    with pytest.raises(ValueError, match="remat"):
        LMModel(reduce_for_smoke(LM_ARCHS["olmo-1b"]), device="cpu",
                remat=remat)


# ---------------------------------------------------------------------------
# (f) the launcher
# ---------------------------------------------------------------------------

def test_launcher_smoke_on_cpu_learns_and_launches_nothing():
    _build.LAUNCHES.reset()
    losses = launch.main(["--arch", "olmo-1b", "--smoke", "--steps", "5",
                          "--batch", "32", "--seq", "64", "--lr", "5",
                          "--device", "cpu", "--log-every", "1"])
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert _build.LAUNCHES.snapshot() == {}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-125m"])
def test_launcher_smoke_trains_the_moe_and_xlstm_families(arch):
    _build.LAUNCHES.reset()
    losses = launch.main(["--arch", arch, "--smoke", "--steps", "5",
                          "--batch", "32", "--seq", "32", "--lr", "5",
                          "--device", "cpu", "--log-every", "1"])
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert _build.LAUNCHES.snapshot() == {}


@pytest.mark.parametrize("flags", [
    ["--mesh", "2x1"], ["--mode", "manual"], ["--comm", "all_to_all"],
    ["--grad-ar-dtype", "bf16"]])
def test_launcher_left_out_flags_raise(flags):
    """The reference's LM branch parses ``--mode``, ``--comm`` and
    ``--grad-ar-dtype`` and reads none of them (``repro/launch/
    train.py:37-45``, ``:89-121``): the port trains the same losses with
    each. ``--mesh 2x1`` asks for two ranks, which one process without a
    process group cannot give: the error names the ``torchrun`` launch."""
    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "8"]
    if flags[0] == "--mesh":
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
            launch.main([*argv, *flags])
        return
    assert launch.main([*argv, *flags]) == launch.main(argv)


def test_launcher_lm_ckpt_dir_is_taken_and_ignored(tmp_path):
    """The reference's LM branch parses ``--ckpt-dir`` and never reads it
    (``repro/launch/train.py:35``, ``:90-127``): the port trains the same
    losses with the flag and writes nothing there."""
    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "8"]
    ckpt = tmp_path / "ckpt"
    with_flag = launch.main([*argv, "--ckpt-dir", str(ckpt)])
    assert with_flag == launch.main(argv)
    assert not ckpt.exists()


def test_flash_bwd_wrapper_checks_shapes():
    q, k = torch.zeros((6, 8, 16)), torch.zeros((2, 8, 16))
    lse = torch.zeros((6, 8))
    with pytest.raises(ValueError, match="must be"):
        flash_bwd(q, k, k, q[:, :4], lse, q)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd(q, k, k, q, lse[:, :4], q)
    with pytest.raises(ValueError):
        flash_bwd(q, k, k, q, lse, torch.zeros((6, 8, 16), device="meta"))
