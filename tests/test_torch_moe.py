"""The port's MoE decoders (granite) against the JAX package's, on the CPU.

Seeded numpy inputs go through both packages, the models reduced by
``reduce_for_smoke`` (2 layers, d 64, 8 experts, top 2, expert F 32, the
published capacity factor 1.25) and built from one JAX ``init``
(``PRNGKey(0)``) carried across by ``convert.lm_params_from_flat``:

* ``_bucket`` on seeded owners with overflow and drops: the int slots of
  the JAX ``_bucket``, bit for bit;
* the top-k selection on logits with exact ties: ``jax.lax.top_k``'s
  experts and order (the lower index first among equal values);
* ``moe_apply`` against ``moe_apply_local`` under ``shard_map`` on a
  one-device mesh, in f32, at the published factor (where drops happen)
  and at a factor that drops nothing: the output within 1e-5, ``sel``,
  the slots and ``valid`` equal; ``aux_load_balance_loss`` within 1e-6;
* ``LMModel.prefill`` and ``decode_step`` of both granite configs: f32
  within 1e-4; bf16 within ``BF16_LOGIT_TOL`` for every sequence whose
  routing has no near tie (the k-th and (k+1)-th router logits within one
  bf16 ulp), and every routing decision of the port's bf16 forward equal
  to the one JAX's router takes on the same layer input, but at a near
  tie in JAX's own logits (the test asserts both; bf16 logits tie
  exactly often: a tie decides the experts by rounding upstream, which
  the two frameworks, and even JAX's eager and compiled forms, place
  apart);
* ``train_loss`` and every gradient against ``jax.value_and_grad``: f32
  within 1e-4 relative to each gradient's largest entry (the 1b config:
  the 3b one reduces to the same shapes);
* the port's decode against its own prefill on a copy whose capacity
  factor drops nothing (at the published factor a decode step's two
  tokens may compete for one slot, which is why the reference's own
  check leaves granite out), under the reference's bounds;
* every remat policy: the same loss and gradients as ``none``;
* a CPU forward launches no kernel, and the default device is ``cuda``.

TF32 is pinned off (it only matters on a card). S is a multiple of the
JAX attention chunk (8).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs.registry import LM_ARCHS as J_ARCHS
from repro.configs.registry import reduce_for_smoke as j_reduce
from repro.launch.mesh import make_test_mesh
from repro.models.lm import moe as jmoe
from repro.models.lm import transformer as jtf
from repro.models.lm.backbone import LMModel as JLMModel

from repro_torch import convert
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
from repro_torch.kernels import _build
from repro_torch.launch import train as launch
from repro_torch.models.lm import moe
from repro_torch.models.lm.backbone import REMATS, LMModel
from repro_torch.tree import flatten

GRANITE = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")
CHUNK = 8
S = 16
#: bf16 prefill logits, port against JAX (as ``tests/test_torch_lm.py``)
BF16_LOGIT_TOL = 0.1


@pytest.fixture(autouse=True)
def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _cfgs(arch, dtype="f32", factor=None):
    jcfg, pcfg = (dataclasses.replace(j_reduce(J_ARCHS[arch]), dtype=dtype),
                  dataclasses.replace(reduce_for_smoke(LM_ARCHS[arch]),
                                      dtype=dtype))
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=factor))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=factor))
    return jcfg, pcfg


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten(tree)}


@functools.lru_cache(maxsize=None)
def _jax(arch, dtype):
    """The JAX model, its init from PRNGKey(0), and jitted prefill,
    decode_step and value_and_grad (shared across the tests)."""
    jcfg, _ = _cfgs(arch, dtype)
    mesh = make_test_mesh((1, 1))
    with mesh:
        model = JLMModel(jcfg, mesh, embed_mode="replicated",
                         q_chunk=CHUNK, k_chunk=CHUNK, loss_chunk=CHUNK)
        params = model.init(jax.random.PRNGKey(0))
    return (mesh, model, params, jax.jit(model.prefill),
            jax.jit(model.decode_step),
            jax.jit(jax.value_and_grad(model.train_loss)))


def _port(arch, dtype, **kw):
    _, _, jparams, *_ = _jax(arch, dtype)
    _, pcfg = _cfgs(arch, dtype)
    model = LMModel(pcfg, device="cpu", embed_mode="replicated",
                    loss_chunk=CHUNK, **kw)
    return model, convert.lm_params_from_flat(_flat_np(jparams),
                                              device="cpu")


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _moe_layer(arch="granite-moe-1b-a400m", i=0):
    _, _, jparams, *_ = _jax(arch, "f32")
    return jax.tree.map(lambda a: np.asarray(a)[i],
                        jparams["groups"]["0_attn"]["ffn"])


def _to_torch(tree):
    return {k: (_to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_buckets,capacity", [(8, 3), (5, 1), (40, 20)])
def test_bucket_slots_equal_jax(n_buckets, capacity):
    """Owners drawn so that some buckets overflow, with drops
    (``owner == n_buckets``) among them."""
    rng = np.random.default_rng(n_buckets)
    owner = rng.integers(0, n_buckets + 1, 4 * n_buckets * capacity)
    owner[: 3 * capacity] = 0                       # bucket 0 overflows
    want = np.asarray(jmoe._bucket(jnp.asarray(owner, jnp.int32),
                                   n_buckets, capacity))
    got = moe._bucket(torch.from_numpy(owner), n_buckets, capacity)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == n_buckets * capacity).any()
    assert (want < n_buckets * capacity).any()


def test_top_k_keeps_the_lower_index_first_on_ties():
    rng = np.random.default_rng(0)
    # few distinct values a row: most rows hold ties at and inside the
    # top k, as bf16 router logits do
    logits = rng.integers(0, 4, (64, 40)).astype(np.float32) / 4
    logits[0] = 1.0                                 # all equal
    for k in (1, 2, 8):
        want_v, want_i = jax.lax.top_k(jnp.asarray(logits), k)
        got_v, got_i = moe._top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _jax_routing(p, x, cfg):
    """``sel``, slots and ``valid`` as ``moe_apply_local`` computes them at
    a model axis of one device."""
    h = jtf.norm_apply(p["norm"], x, cfg)
    logits = (h @ p["router"].astype(x.dtype)).astype(jnp.float32)
    _, sel = jax.lax.top_k(logits, cfg.moe.top_k)
    n = x.shape[0] * x.shape[1]
    capacity = max(1, int(n * cfg.moe.top_k / cfg.moe.num_experts
                          * cfg.moe.capacity_factor))
    e = cfg.moe.num_experts
    slot = jmoe._bucket(sel.reshape(-1), e, capacity)
    return np.asarray(sel), np.asarray(slot), np.asarray(slot < e * capacity)


class _Recorder:
    """Wraps ``moe._top_k`` and ``moe._bucket`` to keep what the port's
    ``moe_apply`` computed: the router logits, ``sel`` and the slots."""

    def __init__(self, monkeypatch):
        self.logits, self.sel, self.slot, self.n_buckets = [], [], [], []
        top_k, bucket = moe._top_k, moe._bucket

        def rec_top_k(logits, k):
            vals, sel = top_k(logits, k)
            self.logits.append(logits.detach().numpy())
            self.sel.append(sel.numpy())
            return vals, sel

        def rec_bucket(owner, n_buckets, capacity):
            slot = bucket(owner, n_buckets, capacity)
            self.slot.append(slot.numpy())
            self.n_buckets.append(n_buckets * capacity)
            return slot

        monkeypatch.setattr(moe, "_top_k", rec_top_k)
        monkeypatch.setattr(moe, "_bucket", rec_bucket)


@pytest.mark.parametrize("factor,drops", [(None, True), (4.0, False)],
                         ids=["published", "no-drop"])
def test_moe_apply_matches_moe_apply_local(monkeypatch, factor, drops):
    jcfg, pcfg = _cfgs("granite-moe-1b-a400m", "f32", factor)
    p = _moe_layer()
    # 16 tokens: buckets of 5 (4 assignments an expert on average) at
    # the published factor, so some overflow
    x = np.random.default_rng(1).standard_normal(
        (2, 8, jcfg.d_model)).astype(np.float32)
    fn = jax.jit(compat.shard_map(
        functools.partial(jmoe.moe_apply_local, cfg=jcfg,
                          model_axis="model", model_axis_size=1),
        mesh=make_test_mesh((1, 1)),
        in_specs=(jax.tree.map(lambda _: P(), p), P()), out_specs=P(),
        check_vma=False))
    want = np.asarray(fn(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    rec = _Recorder(monkeypatch)
    got = moe.moe_apply(_to_torch(p), torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    sel, slot, valid = _jax_routing(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(rec.sel[0], sel)
    np.testing.assert_array_equal(rec.slot[0], slot)
    np.testing.assert_array_equal(rec.slot[0] < rec.n_buckets[0], valid)
    assert (~valid).any() == drops


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, S, 8)).astype(np.float32)
    sel = np.argsort(-logits, -1, kind="stable")[..., :2]
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(sel),
                                      8)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(sel), 8)
    assert abs(float(got) - float(want)) <= 1e-6


def test_expert_parallelism_raises():
    """The expert count padded to the model axis, as the reference pads
    it, for both granite configs at model axes 1-4 (the MoE over a mesh
    itself: ``tests/test_torch_lm_mesh.py``)."""
    for arch in GRANITE:
        jcfg, pcfg = J_ARCHS[arch], LM_ARCHS[arch]
        for m in (1, 2, 3, 4):
            assert moe.padded_experts(pcfg, m) == \
                jmoe.padded_experts(jcfg, m), (arch, m)
    assert moe.padded_experts(LM_ARCHS["granite-moe-3b-a800m"], 3) == 42


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------

def test_init_has_the_reference_tree():
    for arch in GRANITE:
        _, _, jparams, *_ = _jax(arch, "f32")
        model, _ = _port(arch, "f32")
        own = model.init(torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in flatten(own)} == \
            {k: v.shape for k, v in _flat_np(jparams).items()}
        assert set(own["groups"]["0_attn"]["ffn"]) == {"router", "w1", "w2",
                                                      "w3", "norm"}


@pytest.mark.parametrize("arch", GRANITE)
def test_prefill_and_decode_match_jax_f32(arch):
    mesh, jmodel, jparams, jprefill, jdecode, _ = _jax(arch, "f32")
    model, params = _port(arch, "f32")
    tokens = _tokens(2, (4, S))
    with mesh:
        want = np.asarray(jprefill(jparams, {"tokens": jnp.asarray(tokens)}))
    got = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    b, steps = 4, 4
    jcache, cache = jmodel.init_cache(b, 8), model.init_cache(b, 8)
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


def _ulp_bf16(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _near_ties(logits, k):
    """Per token, whether its k-th and (k+1)-th logits lie within one bf16
    ulp of each other, or any two of its top k do (an order tie)."""
    top = -np.sort(-logits, -1)[..., :k + 1]
    gaps = top[..., :-1] - top[..., 1:]
    return (gaps <= _ulp_bf16(top[..., 1:])).any(-1)


def _check_routing_against_jax(rec, jparams, jcfg, n_layers):
    """Each recorded MoE call of the port's bf16 forward: JAX's router on
    the same layer input picks the same experts in the same order, but
    where the port's choice at a rank is within one bf16 ulp of JAX's in
    JAX's own logits. Returns the calls' near-tie masks per sequence."""
    k = jcfg.moe.top_k
    ties = []
    for call, (logits, sel) in enumerate(zip(rec.logits, rec.sel)):
        layer = call % n_layers
        router = jnp.asarray(np.asarray(
            jparams["groups"]["0_attn"]["ffn"]["router"])[layer],
            jnp.bfloat16)
        jl = np.asarray((jnp.asarray(rec.h[call], jnp.bfloat16) @ router)
                        .astype(jnp.float32))
        jsel = np.asarray(jax.lax.top_k(jnp.asarray(jl), k)[1])
        differ = sel != jsel
        picked = np.take_along_axis(jl, sel, -1)
        wanted = np.take_along_axis(jl, jsel, -1)
        assert (np.abs(picked - wanted) <= _ulp_bf16(wanted))[differ].all()
        ties.append(_near_ties(logits, k).reshape(logits.shape[0], -1)
                    .any(-1))
    return np.any(ties, axis=0)


@pytest.mark.parametrize("arch", GRANITE)
def test_prefill_and_decode_match_jax_bf16(monkeypatch, arch):
    mesh, jmodel, jparams, jprefill, jdecode, _ = _jax(arch, "bf16")
    jcfg, _ = _cfgs(arch, "bf16")
    model, params = _port(arch, "bf16")
    rec = _Recorder(monkeypatch)
    rec.h = []
    apply = moe.moe_apply

    def rec_apply(p, x, cfg):
        rec.h.append(np.asarray(jtf.norm_apply(
            jax.tree.map(jnp.asarray, {k: v.numpy() for k, v in
                                       p["norm"].items()}),
            jnp.asarray(x.float().numpy(), jnp.bfloat16), jcfg)
            .astype(jnp.float32)))
        return apply(p, x, cfg)

    monkeypatch.setattr(moe, "moe_apply", rec_apply)
    tokens = _tokens(3, (8, S))
    held = 0
    # one sequence a call: a routing flip in one sequence then cannot move
    # another's bucket positions
    for row in tokens:
        rec.logits.clear(), rec.sel.clear(), rec.h.clear()
        with mesh:
            want = np.asarray(jprefill(jparams,
                                       {"tokens": jnp.asarray(row[None])}))
        got = model.prefill(params, {"tokens": torch.from_numpy(row[None])})
        tie = _check_routing_against_jax(rec, jparams, jcfg,
                                         jcfg.num_layers)[0]
        if not tie:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=BF16_LOGIT_TOL)
            held += 1
    # 3 of the 8 have no near tie in either layer of the 1b config
    assert held >= 2, held
    # decode: 4 steps of one sequence each; a step routes the batch's tokens
    for row in tokens[:4]:
        jcache, cache = jmodel.init_cache(1, 8), model.init_cache(1, 8)
        rec.logits.clear(), rec.sel.clear(), rec.h.clear()
        for i in range(4):
            pos = np.zeros((1,), np.int32) + i
            with mesh:
                want, jcache = jdecode(jparams,
                                       jnp.asarray(row[None, i:i + 1]),
                                       jcache, jnp.asarray(pos))
            got, cache = model.decode_step(
                params, torch.from_numpy(row[None, i:i + 1]), cache,
                torch.from_numpy(pos))
        if not _check_routing_against_jax(rec, jparams, jcfg,
                                          jcfg.num_layers)[0]:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=BF16_LOGIT_TOL)


def test_train_loss_and_grads_match_jax():
    """On the 1b config (the 3b one reduces to the same shapes)."""
    arch = GRANITE[0]
    mesh, _, jparams, _, _, jvg = _jax(arch, "f32")
    tokens = _tokens(4, (2, S))
    with mesh:
        jloss, jgrads = jvg(jparams, {"tokens": jnp.asarray(tokens)})
    model, params = _port(arch, "f32")
    loss, grads = launch.lm_value_and_grad(model, params,
                                           torch.from_numpy(tokens))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want, got = _flat_np(jgrads), {k: v.numpy() for k, v in flatten(grads)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("arch", GRANITE)
def test_decode_matches_prefill_without_drops(arch):
    """The reference's bounds for the same check, on a copy whose capacity
    factor (``num_experts / top_k``) makes every bucket hold all tokens."""
    cfg = reduce_for_smoke(LM_ARCHS[arch])
    cfg = dataclasses.replace(cfg, moe=MoEConfig(
        num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        expert_d_ff=cfg.moe.expert_d_ff,
        capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = LMModel(cfg, device="cpu", embed_mode="replicated")
    params = model.init(torch.Generator().manual_seed(0))
    b, s = 2, 8
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
        model, params = _port("granite-moe-1b-a400m", "f32", remat=remat)
        loss, grads = launch.lm_value_and_grad(model, params, tokens)
        if base is None:
            base_loss, base = float(loss), flatten(grads)
            continue
        assert abs(float(loss) - base_loss) <= 1e-6 * abs(base_loss), remat
        for (k, g), (_, w) in zip(flatten(grads), base):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6,
                                       msg=f"{remat} {k}")


def test_cpu_prefill_launches_nothing_and_the_default_is_cuda():
    model = LMModel(reduce_for_smoke(LM_ARCHS["granite-moe-3b-a800m"]),
                    device="cpu")
    params = model.init()
    _build.LAUNCHES.reset()
    out = model.prefill(params, {"tokens": torch.from_numpy(
        _tokens(2, (2, 5)))})
    assert out.shape == (2, model.logits_size) and torch.isfinite(out).all()
    assert _build.LAUNCHES.snapshot() == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LMModel(reduce_for_smoke(LM_ARCHS["granite-moe-1b-a400m"]))
