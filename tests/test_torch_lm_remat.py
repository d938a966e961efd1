"""The LM remat policies ``dots`` and ``group`` against ``none`` and
against the JAX package's, on the CPU.

For olmo-1b and recurrentgemma-9b reduced by ``reduce_for_smoke``, in
f32, from
one JAX ``init`` (``PRNGKey(0)``, ``convert.lm_params_from_flat``):

* ``train_loss`` and every gradient under ``dots`` and ``group`` equal
  ``none``'s within 1e-6, and ``jax.value_and_grad`` of the JAX model in
  the same mode within 1e-5 (the loss 1e-5 relative);
* what each policy recomputes, by the matmuls (``mm``, ``addmm``,
  ``bmm``) that run during backward: ``dots`` runs none of the forward's
  again (it saved their outputs), as ``none``; ``full`` runs each layer's
  once more; ``group`` the grouped layers' twice (the group, then each
  layer inside it); the tail layers are never recomputed;
* on the kernel path (``ops.flash_attention``'s ``autograd.Function``,
  with K7 and K8 swapped for their plain versions, as the card runs it):
  every policy gives ``none``'s loss and gradients within 1e-6, and K7
  runs again in backward under ``dots`` as under ``full`` (its output is
  not a matmul's, as a ``pallas_call``'s is not a ``dot_general``'s under
  ``checkpoint_dots``), and twice under ``group``.

S is a multiple of the JAX attention chunk (see ``test_torch_rglru.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.configs.registry import LM_ARCHS as J_ARCHS
from repro.configs.registry import reduce_for_smoke as j_reduce
from repro.launch.mesh import make_test_mesh
from repro.models.lm.backbone import LMModel as JLMModel

from repro_torch import convert
from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.launch import train as launch
from repro_torch.models.lm.backbone import LMModel, _layers
from repro_torch.tree import flatten

ARCHS = ("olmo-1b", "recurrentgemma-9b")
CHUNK = 8
S = 16


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten(tree)}


@functools.lru_cache(maxsize=None)
def _jax(arch, remat):
    """The JAX loss and gradients of one batch under ``remat``, and the
    init they start from."""
    jcfg = dataclasses.replace(j_reduce(J_ARCHS[arch]), dtype="f32")
    mesh = make_test_mesh((1, 1))
    with mesh:
        model = JLMModel(jcfg, mesh, q_chunk=CHUNK, k_chunk=CHUNK,
                         loss_chunk=CHUNK, remat=remat)
        params = model.init(jax.random.PRNGKey(0))
        loss, grads = jax.jit(jax.value_and_grad(model.train_loss))(
            params, {"tokens": jnp.asarray(_tokens())})
    return _flat_np(params), float(loss), _flat_np(grads)


def _tokens():
    return np.random.default_rng(11).integers(0, 512, (2, S)).astype(
        np.int32)


def _port(arch, remat):
    flat, _, _ = _jax(arch, "none")
    cfg = dataclasses.replace(reduce_for_smoke(LM_ARCHS[arch]), dtype="f32")
    model = LMModel(cfg, device="cpu", loss_chunk=CHUNK, remat=remat)
    return model, convert.lm_params_from_flat(flat, device="cpu")


@functools.lru_cache(maxsize=None)
def _port_loss_grads(arch, remat):
    model, params = _port(arch, remat)
    loss, grads = launch.lm_value_and_grad(model, params,
                                           torch.from_numpy(_tokens()))
    return float(loss), {k: v.numpy() for k, v in flatten(grads)}


@pytest.mark.parametrize("remat", ["dots", "group"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_none_and_jax(arch, remat):
    loss, grads = _port_loss_grads(arch, remat)
    base_loss, base = _port_loss_grads(arch, "none")
    _, jloss, jgrads = _jax(arch, remat)
    assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert grads.keys() == base.keys() == jgrads.keys()
    for k in base:
        np.testing.assert_allclose(grads[k], base[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=0, atol=1e-5,
                                   err_msg=k)


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


def _backward_matmuls(arch, remat):
    model, params = _port(arch, remat)
    for _, p in flatten(params):
        p.requires_grad_(True)
    # a recompute runs the whole function (by default it stops once the
    # tensors backward needs are back, skipping a layer's last products)
    with set_checkpoint_early_stop(False):
        loss = model.train_loss(params,
                                {"tokens": torch.from_numpy(_tokens())})
        with _CountMatmuls() as count:
            loss.backward()
    return count.n


def _grouped_forward_matmuls(arch):
    """Matmuls in one forward of every layer of the pattern groups (the
    tail's not counted)."""
    model, params = _port(arch, "none")
    x = torch.zeros((2, S, model.cfg.d_model))
    pos = torch.arange(S)[None].expand(2, S)
    total = 0
    for key, kind, n in model._group_keys():
        if key.startswith("tail"):
            continue
        for lp in _layers(params["groups"][key], n):
            with _CountMatmuls() as count:
                model._apply_block(kind, lp, x, positions=pos)
            total += count.n
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_what_each_policy_recomputes(arch):
    """olmo-smoke: 2 grouped layers, no tail (``group``: one block of 2);
    recurrentgemma-smoke: 1 layer in each of 3 pattern slots (one block
    of 1 each) and a 2-layer tail."""
    n = {remat: _backward_matmuls(arch, remat)
         for remat in ("none", "dots", "full", "group")}
    fwd = _grouped_forward_matmuls(arch)
    assert fwd > 0
    assert n["dots"] == n["none"]
    assert n["full"] == n["none"] + fwd
    assert n["group"] == n["none"] + 2 * fwd


@pytest.fixture
def kernel_path(monkeypatch):
    """``ops.flash_attention`` on its kernel path, with K7 and K8 swapped
    for their plain versions (under ``no_grad``, as opaque to autograd as
    the kernels' output buffers); returns the calls it made."""
    calls = []

    def fake_fwd(q, k, v, *, causal, window, q_pos0=0):
        calls.append("fwd")
        with torch.no_grad():
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_pos0=q_pos0)

    def fake_bwd(q, k, v, o, lse, do, *, causal, window, q_pos0=0):
        calls.append("bwd")
        with torch.no_grad():
            return flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           q_pos0=q_pos0)

    monkeypatch.setattr(ops, "_use_kernel", lambda *ts: True)
    monkeypatch.setattr(ops, "flash_fwd", fake_fwd)
    monkeypatch.setattr(ops, "flash_bwd", fake_bwd)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_the_kernel_path_matches_none(arch, kernel_path):
    n_attn = {"olmo-1b": 2, "recurrentgemma-9b": 1}[arch]
    out = {}
    for remat in ("none", "full", "dots", "group"):
        kernel_path.clear()
        model, params = _port(arch, remat)
        with set_checkpoint_early_stop(False):
            loss, grads = launch.lm_value_and_grad(
                model, params, torch.from_numpy(_tokens()))
        out[remat] = (float(loss), grads, kernel_path.count("fwd"))
        assert kernel_path.count("bwd") == n_attn
    base_loss, base, fwd = out["none"]
    assert fwd == n_attn
    for remat, (loss, grads, fwd) in out.items():
        assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
        for (k, g), (_, b) in zip(flatten(grads), flatten(base)):
            torch.testing.assert_close(g, b, rtol=0, atol=1e-6, msg=k)
        # forward, then once a checkpoint level in backward
        runs = {"none": 1, "full": 2, "dots": 2, "group": 3}[remat]
        assert fwd == runs * n_attn, remat
