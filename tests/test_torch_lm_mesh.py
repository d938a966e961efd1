"""The LM on a mesh: the port against the JAX package.

The port runs as four ``gloo`` ranks on a (2, 2) ``("data", "model")``
mesh (one process a device, spawned with ``torch.multiprocessing`` on a
``FileStore``), the reference as its own tests run it: one subprocess with
four forced host devices (``--xla_force_host_platform_device_count=4``).
The reference draws each case's init at the mesh's padded shapes and
exports it; each rank keeps its shards of it (``LMModel.shard_params``)
and trains on its data block of the same global tokens. Every case runs
once, in a module fixture (the two sides at once, each writing ``.npz``
results and waiting, with a time limit, for the files it needs from the
other), and the tests compare, from reduced configs (``reduce_for_smoke``,
tokens ``[4, 32]``, loss chunks of 16):

* olmo-1b, ``sharded``, tied, f32: the loss, every whole gradient
  (``LMModel.gather_params``) and ``prefill``'s logits against JAX's
  (2, 2) run and the port's one-device run, <= 1e-5;
* phi3-mini, ``sharded``, untied, f32, V 511 (``vocab_pad`` 512: the
  padding column masked out of the loss) against JAX's, <= 1e-5;
* granite-moe-1b, ``hybrid``, f32, its published capacity factor 1.25
  (``cold_rows`` 487 -> 488; assignments dropped): against JAX's (2, 2)
  run, <= 1e-5, ``prefill``'s logits and one ``decode_step`` too (the
  capacity comes from the rank's block, so the mesh drops other
  assignments than one device, as in the reference);
* the same at capacity factor 8.0 (nothing dropped): against JAX's and the
  port's one-device run, <= 1e-5;
* granite-moe-1b with 5 experts (padded to 6, the padding masked out of
  routing) in its own bf16, against JAX's (2, 2) run within
  ``BF16_LOSS_REL`` and ``BF16_GRAD_REL``;
* the ``"seq"`` partition forced (``attn_partition="seq"`` on both
  sides: sequence-parallel attention over ``"model"``, each rank its 16
  query rows through ``transformer.seqpar_shard``): minitron-4b,
  ``sharded``, untied, f32, the loss, every whole gradient and
  ``prefill``'s logits against JAX's (2, 2) ``"seq"`` run and the port's
  one-device run, <= 1e-5; granite-moe-1b, ``hybrid``, in its own bf16
  (MoE beside the seq attention) against JAX's within ``BF16_LOSS_REL``
  and ``BF16_GRAD_REL``; olmo-1b at a sequence of 15, which the model
  axis does not divide (both packages fall back to whole attention),
  against JAX's and the port's one-device run, <= 1e-5;
* ``python -m repro_torch.launch.train --arch granite-moe-1b-a400m
  --smoke --mesh 2x2 --device cpu`` on the four ranks against the
  reference's LM branch (``repro/launch/train.py``) on a (2, 2) mesh from
  the same seed-0 weights, within ``LAUNCHER_TOL`` (bf16).

Without ranks: ``attn_partition``, ``fsdp``, ``hot_rows``, ``cold_rows``,
``vocab_pad`` and ``padded_experts`` for every LM arch at full size on
(4, 1), (2, 2) and (1, 4), with and without remat, equal to the
reference's (the ``"seq"`` ones, minitron-4b and granite-moe-3b on a
model axis of 16 aside, included: command-r-plus in training).

A rank that dies or overruns its time fails the test; nothing waits
forever.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, S, CHUNK = 4, 32, 16
DECODE_LEN = 32
#: f32 sum order
TOL = 1e-5
#: bf16 against JAX's bf16 (the frameworks round at other points, and a
#: router logit near a tie may pick another expert): the loss, relative;
#: each gradient's relative L2 error
BF16_LOSS_REL = 2e-3
BF16_GRAD_REL = 5e-2
#: bf16 on the "seq" partition: JAX's sequence-parallel shards round p to
#: bf16 before the PV product (``p_dtype=vf.dtype``, its folded chunks),
#: the port's plain attention keeps it f32 (K7 on the card rounds it as
#: JAX does), so its bf16 gradients are held by their drift from JAX's
#: f32 gradients of the same init and tokens: at most ``BF16_DRIFT`` x
#: JAX's own bf16 gradients' drift, plus 2e-3 (relative L2 each)
BF16_DRIFT = 1.5
#: the launcher's bf16 losses against the reference's LM branch's
LAUNCHER_TOL = 1e-2
LAUNCHER_ARGS = ["--arch", "granite-moe-1b-a400m", "--smoke", "--mesh",
                 "2x2", "--steps", "3", "--batch", "8", "--seq", "32",
                 "--lr", "5", "--log-every", "1"]
#: the processes of the module: ranks and the JAX subprocess
TIMEOUT_S = 300

#: cases: (arch, embed mode, dtype, vocabulary, capacity factor, experts,
#: attention partition; None: the reduced config's own, "auto": the rule's)
CASES = {
    "olmo": ("olmo-1b", "sharded", "f32", None, None, None, "auto"),
    "phi3": ("phi3-mini-3.8b", "sharded", "f32", 511, None, None, "auto"),
    "granite": ("granite-moe-1b-a400m", "hybrid", "f32", None, None, None,
                "auto"),
    "granite_nodrop": ("granite-moe-1b-a400m", "hybrid", "f32", None, 8.0,
                       None, "auto"),
    "granite_bf16": ("granite-moe-1b-a400m", "hybrid", "bf16", None, None,
                     5, "auto"),
    "minitron_seq": ("minitron-4b", "sharded", "f32", None, None, None,
                     "seq"),
    "granite_seq_bf16": ("granite-moe-1b-a400m", "hybrid", "bf16", None,
                         None, None, "seq"),
    "olmo_seq_odd": ("olmo-1b", "sharded", "f32", None, None, None, "seq"),
}
#: a case's sequence where it is not ``S``: 15 tokens, which the model
#: axis of 2 does not divide
SEQ = {"olmo_seq_odd": 15}
LOGITS = ("olmo", "granite", "minitron_seq")
#: the bf16 cases whose gradients are held by their drift from JAX's f32
#: gradients of the same init and tokens (``BF16_DRIFT``)
DRIFT = ("granite_seq_bf16",)
DECODE = ("granite",)
SHAPES = ((4, 1), (2, 2), (1, 4))


def _case_cfg(case, archs, reduce):
    """A case's reduced config (either package's), its embed mode and its
    attention partition."""
    arch, mode, dtype, vocab, factor, experts, attn = CASES[case]
    cfg = dataclasses.replace(reduce(archs[arch]), dtype=dtype)
    if vocab is not None:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    if factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg, mode, attn


def _tokens(case, vocab):
    seed = list(CASES).index(case)
    return np.random.default_rng(100 + seed).integers(
        0, vocab, (B, SEQ.get(case, S))).astype(np.int32)


def _data(path):
    return dict(np.load(path, allow_pickle=False))


def _wait_for(path, limit_s=TIMEOUT_S - 30):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > limit_s:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _rank_entry(rank, world, store_path, tmp, err_dir):
    """One gloo rank: join the group, run every port case, write results
    (rank 0) and, on an error, its traceback."""
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        _port_cases(rank, tmp)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(err_dir, f"rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _port_cases(rank, tmp):
    from repro_torch import convert
    from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
    from repro_torch.core.embedding.strategies import all_gather
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.train import lm_value_and_grad
    from repro_torch.models.lm import transformer as tf
    from repro_torch.models.lm.backbone import LMModel
    mesh = meshlib.make_test_mesh((2, 2))
    dp = meshlib.axis_group(mesh, ("data",))
    # the shards this rank attends through seqpar_shard: (index, rows)
    shards, shard_fn = [], tf.seqpar_shard

    def counted_shard(q, k, v, index, shard, use_kernels=True):
        shards.append((index, shard))
        return shard_fn(q, k, v, index, shard, use_kernels)

    tf.seqpar_shard = counted_shard
    meta = {}

    def save(name, arrays):
        if rank == 0:
            path = os.path.join(tmp, name)
            np.savez(path + ".tmp.npz", **arrays)
            os.rename(path + ".tmp.npz", path)

    for case in CASES:
        cfg, mode, attn = _case_cfg(case, LM_ARCHS, reduce_for_smoke)
        path = os.path.join(tmp, f"in_{case}.npz")
        _wait_for(path)
        model = LMModel(cfg, mesh, device="cpu", embed_mode=mode,
                        loss_chunk=CHUNK, attn_partition=attn)
        del shards[:]
        params = model.shard_params(convert.lm_params_from_flat(
            _data(path), device="cpu"))
        tokens = model.data_block(torch.from_numpy(_tokens(
            case, cfg.vocab_size)))
        loss, grads = lm_value_and_grad(model, params, tokens)
        out = {"loss": loss.numpy(), **{
            f"g/{k}": v for k, v in convert.lm_params_to_flat(
                model.gather_params(grads)).items()}}
        with torch.no_grad():
            if case in LOGITS:
                out["prefill"] = all_gather(model.prefill(
                    params, {"tokens": tokens}), dp).numpy()
            if case in DECODE:
                b = tokens.shape[0]
                logits, _ = model.decode_step(
                    params, tokens[:, :1], model.init_cache(b, DECODE_LEN),
                    torch.zeros(b, dtype=torch.int64))
                out["decode"] = all_gather(logits, dp).numpy()
        save(f"port_{case}.npz", out)
        meta[case] = {"attn_partition": model.attn_partition,
                      "model_index": model._model_index,
                      "shards": sorted(set(shards))}
    if rank == 0:
        with open(os.path.join(tmp, "port_meta.json"), "w") as f:
            json.dump(meta, f)

    # the launcher's seed-0 weights, for the reference's LM branch
    cfg = reduce_for_smoke(LM_ARCHS[LAUNCHER_ARGS[1]])
    seq = int(LAUNCHER_ARGS[LAUNCHER_ARGS.index("--seq") + 1])
    model = LMModel(cfg, mesh, device="cpu", loss_chunk=min(seq, 128))
    init = model.gather_params(model.init(torch.Generator().manual_seed(0)))
    save("port_launcher_init.npz", convert.lm_params_to_flat(init))
    losses = launch_train.main([*LAUNCHER_ARGS, "--device", "cpu"])
    if rank == 0:
        with open(os.path.join(tmp, "port_launcher.json"), "w") as f:
            json.dump({"losses": losses, "attn_partition":
                       model.attn_partition}, f)


# ---------------------------------------------------------------------------
# the reference's subprocess
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import contextlib, dataclasses, io, json, os, re, sys, time
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import LM_ARCHS, reduce_for_smoke
from repro.launch.mesh import make_test_mesh
from repro.models.lm import moe as jmoe
from repro.models.lm.backbone import LMModel
from repro.train.checkpoint import flatten_tree, unflatten_like

tmp = sys.argv[1]
# the test module's cases and helpers, without importing torch here
exec(sys.argv[2])

def save(name, **arrays):
    path = os.path.join(tmp, name)
    np.savez(path + '.tmp.npz', **arrays)
    os.rename(path + '.tmp.npz', path)

def flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}

mesh = make_test_mesh((2, 2))
for i, case in enumerate(CASES):
    cfg, mode, attn = _case_cfg(case, LM_ARCHS, reduce_for_smoke)
    with mesh:
        m = LMModel(cfg, mesh, embed_mode=mode, q_chunk=CHUNK,
                    k_chunk=CHUNK, loss_chunk=CHUNK, attn_partition=attn)
        params = jax.jit(m.init)(jax.random.PRNGKey(i))
    save(f'in_{case}.npz', **flat_np(params))
    tokens = jnp.asarray(_tokens(case, cfg.vocab_size))
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(m.train_loss))(
            params, {'tokens': tokens})
        out = {'loss': np.asarray(loss),
               **{f'g/{k}': v for k, v in flat_np(grads).items()}}
        if case in LOGITS:
            out['prefill'] = np.asarray(jax.jit(m.prefill)(
                params, {'tokens': tokens}))
        if case in DECODE:
            logits, _ = jax.jit(m.decode_step)(
                params, tokens[:, :1], m.init_cache(B, DECODE_LEN),
                jnp.zeros((B,), jnp.int32))
            out['decode'] = np.asarray(logits)
        if case in DRIFT:
            # the same init, tokens and mesh in f32: what each package's
            # bf16 gradients drift from
            m32 = LMModel(dataclasses.replace(cfg, dtype='f32'), mesh,
                          embed_mode=mode, q_chunk=CHUNK, k_chunk=CHUNK,
                          loss_chunk=CHUNK, attn_partition=attn)
            _, g32 = jax.jit(jax.value_and_grad(m32.train_loss))(
                params, {'tokens': tokens})
            save(f'jax_{case}_f32.npz', **{f'g/{k}': v for k, v in
                                           flat_np(g32).items()})
    save(f'jax_{case}.npz', **out)

# every arch's sizes at full size on each mesh
sizes = {}
for shape in SHAPES:
    mesh = make_test_mesh(shape)
    for arch, cfg in LM_ARCHS.items():
        for remat in ('none', 'full'):
            m = LMModel(cfg, mesh, remat=remat)
            sizes[f'{arch} {shape[0]}x{shape[1]} {remat}'] = dict(
                attn_partition=m.attn_partition, fsdp=bool(m.fsdp),
                embed_mode=m.embed_mode, hot_rows=m.hot_rows,
                cold_rows=m.cold_rows, vocab_pad=m.vocab_pad,
                padded_experts=(jmoe.padded_experts(cfg, m.model_size)
                                if cfg.moe is not None else None))
with open(os.path.join(tmp, 'jax_sizes.json'), 'w') as f:
    json.dump(sizes, f)

# the reference's LM branch, from the port's seed-0 weights
path = os.path.join(tmp, 'port_launcher_init.npz')
t0 = time.time()
while not os.path.exists(path):
    if time.time() - t0 > TIMEOUT_S - 30:
        raise SystemExit("the port's launcher weights never appeared")
    time.sleep(0.2)
init = dict(np.load(path))
draw = LMModel.init
LMModel.init = lambda self, key: jax.tree.map(jnp.asarray, unflatten_like(
    jax.eval_shape(lambda k: draw(self, k), key), init))
from repro.launch import train as jtrain
sys.argv = ['train', *LAUNCHER_ARGS]
log = io.StringIO()
with contextlib.redirect_stdout(log):
    jtrain.main()
text = log.getvalue()
with open(os.path.join(tmp, 'jax_launcher.json'), 'w') as f:
    json.dump({'losses': [float(x) for x in
                          re.findall(r'loss=([-0-9.]+)', text)],
               'log': text}, f)
print('JAX_OK')
"""


# ---------------------------------------------------------------------------
# the module fixture: both packages at once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import inspect
    import multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("lm_mesh"))
    err_dir = os.path.join(tmp, "errors")
    os.makedirs(err_dir)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    log = open(os.path.join(tmp, "jax.log"), "w")
    shared = "\n".join(
        [f"B, S, CHUNK, DECODE_LEN = {B}, {S}, {CHUNK}, {DECODE_LEN}",
         f"TIMEOUT_S = {TIMEOUT_S}", f"CASES = {CASES!r}", f"SEQ = {SEQ!r}",
         f"LOGITS, DECODE, DRIFT = {LOGITS!r}, {DECODE!r}, {DRIFT!r}",
         f"SHAPES = {SHAPES!r}", f"LAUNCHER_ARGS = {LAUNCHER_ARGS!r}"]
        + [inspect.getsource(f) for f in (_case_cfg, _tokens)])
    jproc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, tmp, shared],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    ranks = [ctx.Process(target=_rank_entry,
                         args=(r, WORLD, store, tmp, err_dir))
             for r in range(WORLD)]
    for p in ranks:
        p.start()
    deadline = time.time() + TIMEOUT_S
    for p in ranks:
        p.join(max(1.0, deadline - time.time()))
    failed = [r for r, p in enumerate(ranks)
              if p.is_alive() or p.exitcode != 0]
    if failed:
        for p in ranks:
            if p.is_alive():
                p.terminate()
        jproc.kill()
        errs = "".join(open(os.path.join(err_dir, f)).read()
                       for f in sorted(os.listdir(err_dir)))
        pytest.fail(f"port ranks {failed} died or hung:\n{errs}")
    try:
        jproc.wait(max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        jproc.kill()
        pytest.fail("the reference's subprocess hung")
    log.close()
    if jproc.returncode != 0:
        pytest.fail("the reference's subprocess failed:\n"
                    + open(os.path.join(tmp, "jax.log")).read()[-4000:])
    return tmp


def _load(tmp, name):
    return _data(os.path.join(tmp, name))


def _one_device(runs, case):
    """The port's one-device loss, whole gradients and (for a case of
    ``LOGITS``) ``prefill``'s logits of ``case`` from the case's init, cut
    from the mesh's padded shapes to one device's (the padding rows of a
    striped table are never read and take no gradient)."""
    from repro_torch import convert
    from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
    from repro_torch.launch.train import lm_value_and_grad
    from repro_torch.models.lm.backbone import LMModel
    from repro_torch.tree import flatten
    cfg, mode, _ = _case_cfg(case, LM_ARCHS, reduce_for_smoke)
    model = LMModel(cfg, device="cpu", embed_mode=mode, loss_chunk=CHUNK)
    shapes = {k: v.shape for k, v in flatten(model.init())}
    init = _load(runs, f"in_{case}.npz")
    assert set(init) == set(shapes)
    cut = {k: v[tuple(slice(0, n) for n in shapes[k])]
           for k, v in init.items()}
    params = convert.lm_params_from_flat(cut, device="cpu")
    tokens = torch.from_numpy(_tokens(case, cfg.vocab_size))
    loss, grads = lm_value_and_grad(model, params, tokens)
    logits = None
    if case in LOGITS:
        with torch.no_grad():
            logits = model.prefill(params, {"tokens": tokens}).numpy()
    return float(loss), convert.lm_params_to_flat(grads), logits


# ---------------------------------------------------------------------------
# on the mesh, against the reference's runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["olmo", "phi3", "granite",
                                  "granite_nodrop", "minitron_seq",
                                  "olmo_seq_odd"])
def test_lm_mesh_matches_jax(runs, case):
    want = _load(runs, f"jax_{case}.npz")
    got = _load(runs, f"port_{case}.npz")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert ("prefill" in got) == (case in LOGITS)
    assert ("decode" in got) == (case in DECODE)


@pytest.mark.parametrize("case", ["olmo", "granite_nodrop", "minitron_seq",
                                  "olmo_seq_odd"])
def test_lm_mesh_matches_one_device(runs, case):
    got = _load(runs, f"port_{case}.npz")
    loss, grads, logits = _one_device(runs, case)
    np.testing.assert_allclose(got["loss"], loss, rtol=TOL, atol=TOL)
    if logits is not None:
        np.testing.assert_allclose(got["prefill"][:, :logits.shape[1]],
                                   logits, rtol=TOL, atol=TOL)
    for k, v in grads.items():
        whole = got[f"g/{k}"]
        np.testing.assert_allclose(
            whole[tuple(slice(0, n) for n in v.shape)], v, rtol=TOL,
            atol=TOL, err_msg=k)
        if whole.shape != v.shape:                 # padding: no gradient
            pad = whole.copy()
            pad[tuple(slice(0, n) for n in v.shape)] = 0
            assert not pad.any(), k


def test_published_capacity_drops_by_the_block(runs):
    """At the published capacity factor the capacity comes from the rank's
    block of tokens, so the mesh drops other assignments than one device,
    as the reference's (2, 2) run does (its (1, 1) loss differs too)."""
    got = _load(runs, "port_granite.npz")
    loss, _, _ = _one_device(runs, "granite")
    assert abs(float(got["loss"]) - loss) > 1e-4


def _bf16_within_bound(runs, case):
    """The port's bf16 loss and every whole gradient against JAX's (2, 2)
    run of ``case``: the loss within ``BF16_LOSS_REL``, each gradient's
    relative L2 error within ``BF16_GRAD_REL``; returns the port's."""
    want = _load(runs, f"jax_{case}.npz")
    got = _load(runs, f"port_{case}.npz")
    assert set(got) == set(want)
    w, g = float(want["loss"]), float(got["loss"])
    assert abs(g - w) <= BF16_LOSS_REL * abs(w), (g, w)
    for k, v in want.items():
        if not k.startswith("g/"):
            continue
        a, b = got[k].astype(np.float64), v.astype(np.float64)
        assert a.shape == b.shape, k
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel <= BF16_GRAD_REL, (k, rel)
    return got


def test_lm_mesh_bf16_padded_experts_within_bound(runs):
    got = _bf16_within_bound(runs, "granite_bf16")
    # the padding expert (index 5 of 6) is never routed to: no gradient
    for k in ("w1", "w2", "w3"):
        assert not got[f"g/groups/0_attn/ffn/{k}"][:, 5].any(), k


def test_lm_mesh_seq_bf16_within_bound(runs):
    """granite-moe-1b in bf16 on the ``"seq"`` partition (sequence-
    parallel attention beside the experts over ``"model"``): the loss
    within ``BF16_LOSS_REL`` of JAX's, every whole gradient's drift from
    JAX's f32 gradient within ``BF16_DRIFT`` x JAX's bf16 one's + 2e-3."""
    want = _load(runs, "jax_granite_seq_bf16.npz")
    exact = _load(runs, "jax_granite_seq_bf16_f32.npz")
    got = _load(runs, "port_granite_seq_bf16.npz")
    assert set(got) == set(want) and set(exact) <= set(want)
    w, g = float(want["loss"]), float(got["loss"])
    assert abs(g - w) <= BF16_LOSS_REL * abs(w), (g, w)
    for k, e in exact.items():
        e = e.astype(np.float64)
        norm = max(np.linalg.norm(e), 1e-30)
        drift = np.linalg.norm(got[k].astype(np.float64) - e) / norm
        jdrift = np.linalg.norm(want[k].astype(np.float64) - e) / norm
        assert drift <= BF16_DRIFT * jdrift + 2e-3, (k, drift, jdrift)


@pytest.mark.parametrize("case", ["minitron_seq", "granite_seq_bf16",
                                  "olmo_seq_odd"])
def test_seq_cases_run_sequence_parallel(runs, case):
    """Each ``"seq"`` case built with that partition; rank 0 (model index
    0) attended its own 16 of the 32 query rows in every causal
    self-attention layer, and the case at 15 tokens none (whole
    attention, the fallback)."""
    with open(os.path.join(runs, "port_meta.json")) as f:
        meta = json.load(f)[case]
    assert meta["attn_partition"] == "seq"
    assert meta["model_index"] == 0
    want = [] if case in SEQ else [[0, S // 2]]
    assert meta["shards"] == want


def test_launcher_on_the_mesh_matches_the_reference(runs):
    with open(os.path.join(runs, "port_launcher.json")) as f:
        port = json.load(f)
    with open(os.path.join(runs, "jax_launcher.json")) as f:
        ref = json.load(f)
    steps = int(LAUNCHER_ARGS[LAUNCHER_ARGS.index("--steps") + 1])
    assert len(port["losses"]) == len(ref["losses"]) == steps, ref["log"]
    assert np.isfinite(port["losses"]).all()
    np.testing.assert_allclose(port["losses"], ref["losses"],
                               rtol=0, atol=LAUNCHER_TOL)
    assert f"attn_partition={port['attn_partition']}" in ref["log"]


# ---------------------------------------------------------------------------
# sizes and the attention rule (no ranks)
# ---------------------------------------------------------------------------

def _shape_only_mesh(shape):
    """What ``LMModel`` reads of a mesh to size itself, for a mesh this
    process has no ranks for: its axes, shape and device type."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros(shape), device_type="cpu")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sizes_and_attention_rule_match_jax(runs, shape):
    from repro_torch.configs.registry import LM_ARCHS
    from repro_torch.models.lm import moe
    from repro_torch.models.lm.backbone import LMModel
    with open(os.path.join(runs, "jax_sizes.json")) as f:
        sizes = json.load(f)
    mesh = _shape_only_mesh(shape)
    for arch, cfg in LM_ARCHS.items():
        for remat in ("none", "full"):
            want = sizes[f"{arch} {shape[0]}x{shape[1]} {remat}"]
            m = LMModel(cfg, mesh, device="cpu", remat=remat)
            got = dict(attn_partition=m.attn_partition, fsdp=m.fsdp,
                       embed_mode=m.embed_mode, hot_rows=m.hot_rows,
                       cold_rows=m.cold_rows, vocab_pad=m.vocab_pad,
                       padded_experts=(moe.padded_experts(cfg, shape[1])
                                       if cfg.moe is not None else None))
            assert got == want, (arch, remat)


def test_seq_partition_raises_seqpar():
    """The reference's training rule sends command-r-plus (an FSDP-sized
    model) to sequence-parallel attention, over a model axis of 4 as on
    one of 1, and the model builds on it (it raised before the port had
    ``seqpar_attention``); without remat it keeps ``"heads"``. A forced
    ``"seq"`` builds on (2, 2); an unknown partition raises
    ``ValueError``."""
    from repro_torch.configs.registry import LM_ARCHS, reduce_for_smoke
    from repro_torch.models.lm.backbone import LMModel
    cfg = LM_ARCHS["command-r-plus-104b"]
    m = LMModel(cfg, _shape_only_mesh((1, 4)), device="cpu", remat="full")
    assert m.attn_partition == "seq" and m.fsdp
    assert m._seq_par_mesh is not None
    m = LMModel(cfg, _shape_only_mesh((1, 4)), device="cpu")
    assert m.attn_partition == "heads" and m._seq_par_mesh is None
    assert LMModel(cfg, _shape_only_mesh((4, 1)), device="cpu",
                   remat="full").attn_partition == "seq"
    small = reduce_for_smoke(LM_ARCHS["olmo-1b"])
    m = LMModel(small, _shape_only_mesh((2, 2)), device="cpu",
                attn_partition="seq")
    assert m.attn_partition == "seq" and m._seq_par_mesh is not None
    assert LMModel(small, device="cpu",
                   attn_partition="seq")._seq_par_mesh is None
    with pytest.raises(ValueError, match="attn_partition"):
        LMModel(small, device="cpu", attn_partition="rows")
