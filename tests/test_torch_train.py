"""The port's training half against the JAX package's, on the CPU.

From one JAX-exported initial state (``convert.state_from_flat``), the same
numpy batches go through both packages' models, train steps and trainers:

* ``SyntheticCTR`` batches are bit-identical;
* the planner makes the same ``dp``/``dist`` groups and ``export_logical``
  keys and shapes;
* forward logits (JAX on its Pallas kernels in interpret mode): <= 1e-5
  with ``dtype="f32"``, <= 2e-2 in bf16 (the two frameworks round bf16
  at other points, and at H > 1 the port pools in f32 before rounding);
* 5 train steps: f32 losses <= 1e-5 and params <= 1e-4 (sum order),
  bf16 losses <= 2e-2;
* the optimizers alone (AdamW, Adam, SGD, row-wise AdaGrad, global-norm
  clipping) <= 1e-6;
* a checkpoint written by either package resumes in the other's
  ``Trainer`` (f32 losses <= 1e-5), and an injected failure replays to
  the same final loss.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import shutil

import numpy as np
import jax
import jax.numpy as jnp

from repro.configs.base import (
    EmbeddingTableConfig as JTable, RecsysConfig as JCfg,
    TrainConfig as JTrainConfig)
from repro.core.embedding.planner import resolve_strategies as jresolve
from repro.data.synthetic import SyntheticCTR as JSynthetic
from repro.launch.mesh import make_test_mesh, mesh_config_for
from repro.models.recsys.model import RecsysModel as JModel
from repro.models.recsys.model import export_logical_params as jexport
from repro.optim import optimizers as jopt
from repro.optim import sparse as jsparse
from repro.train import train_step as jts
from repro.train.checkpoint import flatten_tree as jflatten
from repro.train.trainer import Trainer as JTrainer

from repro_torch import convert
from repro_torch.configs.base import (
    SINGLE_DEVICE, EmbeddingTableConfig, RecsysConfig, TrainConfig)
from repro_torch.core.embedding.collection import EmbeddingCollection
from repro_torch.core.embedding.planner import resolve_strategies
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.models.recsys.model import (
    RecsysModel, export_logical_params, import_logical_params)
from repro_torch.optim import optimizers as popt
from repro_torch.optim import sparse as psparse
from repro_torch.train import train_step as pts
from repro_torch.train.trainer import Trainer, put_batch

#: two tables above 1 MiB go to the "dist" group, between "dp" tables
VOCABS = (1000, 20000, 584, 30000, 306, 24)
DIM = 16
BATCH = 64


#: tables pinned to the hybrid hot/cold split in the ``hybrid`` cases
HYBRID_TABLES = (1, 4)


def _cfgs(dtype="bf16", hotness=1, hybrid=False):
    def cfg(table_cls, cfg_cls):
        tables = tuple(table_cls(
            f"C{i + 1}", v, DIM, hotness=hotness,
            strategy="hybrid" if hybrid and i in HYBRID_TABLES else "auto")
            for i, v in enumerate(VOCABS))
        return cfg_cls(name="dlrm-test", model="dlrm", tables=tables,
                       num_dense_features=13, bottom_mlp=(32, DIM),
                       top_mlp=(32, 16, 1), embedding_dim=DIM, dtype=dtype)
    return cfg(JTable, JCfg), cfg(EmbeddingTableConfig, RecsysConfig)


def _pair(dtype="bf16", hotness=1, hybrid=False, seed=0):
    """The JAX model (on its kernels) and the port's, the JAX init
    exported into both."""
    jcfg, pcfg = _cfgs(dtype, hotness, hybrid)
    mesh = make_test_mesh((1, 1))
    with mesh:
        jm = JModel(jcfg, mesh, global_batch=BATCH, use_kernels=True)
        jparams = jm.init(jax.random.PRNGKey(seed))
    pm = RecsysModel(pcfg, device="cpu", global_batch=BATCH)
    tree = convert.state_from_flat(jflatten(jexport(jm, jparams)),
                                   device="cpu")
    return mesh, jm, jparams, pm, import_logical_params(pm, tree)


def _batches(jcfg, n, seed=0):
    data = JSynthetic(jcfg, BATCH, seed=seed)
    return [data.batch(s) for s in range(n)]


def _np(tree):
    return {k: np.asarray(v) for k, v in jflatten(tree).items()}


# ---------------------------------------------------------------------------
# data and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hotness,seed,zipf_a", [(1, 0, 1.1), (3, 5, 1.3)])
def test_synthetic_batches_bit_identical(hotness, seed, zipf_a):
    jcfg, pcfg = _cfgs(hotness=hotness)
    j = JSynthetic(jcfg, 37, seed=seed, zipf_a=zipf_a)
    p = SyntheticCTR(pcfg, 37, seed=seed, zipf_a=zipf_a)
    for step in (0, 1, 17):
        a, b = j.batch(step), p.batch(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("batch", [16, 64, 4096])
def test_planner_groups_and_export_keys_match_jax(batch):
    jcfg, pcfg = _cfgs()
    mesh = make_test_mesh((1, 1))
    jt = jresolve(jcfg.tables, mesh_config_for(mesh), batch)
    pt = resolve_strategies(pcfg.tables, SINGLE_DEVICE, batch)
    assert [t.strategy for t in jt] == [t.strategy for t in pt]
    with mesh:
        jm = JModel(jcfg, mesh, global_batch=batch)
        jshapes = jax.tree.map(
            lambda a: np.empty(a.shape, a.dtype), jax.eval_shape(
                lambda: jexport(jm, jm.init(jax.random.PRNGKey(0)))))
    pm = RecsysModel(pcfg, device="cpu", global_batch=batch)
    assert list(pm.embedding.groups) == list(jm.embedding.groups)
    for k, g in pm.embedding.groups.items():
        jg = jm.embedding.groups[k]
        assert (g.offsets, g.total_rows, g.table_indices) == \
            (jg.offsets, jg.total_rows, jg.table_indices)
    pshapes = export_logical_params(
        pm, pm.init(torch.Generator().manual_seed(0)))
    want = {k: tuple(v.shape) for k, v in jflatten(jshapes).items()}
    got = {k: tuple(v.shape) for k, v in convert.state_to_flat(
        pshapes).items()}
    assert got == want


def test_unported_placements_raise():
    _, pcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        EmbeddingCollection(pcfg.tables, comm="all_to_all", device="cpu")
    tables = tuple(dataclasses.replace(t, strategy="localized")
                   for t in pcfg.tables)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        EmbeddingCollection(tables, device="cpu")


def test_hybrid_groups_and_logical_tables_match_jax():
    """The hybrid hot/cold split (what the planner picks for mid-sized
    tables at large batches) has the reference's layout, and its logical
    per-table export equals the reference's."""
    from repro.models.recsys.model import logical_tables as jlogical
    mesh, jm, jparams, pm, pparams = _pair("f32", hybrid=True)
    assert list(pm.embedding.groups) == list(jm.embedding.groups) \
        == ["dp", "dist", "hot", "cold"]
    for k, g in pm.embedding.groups.items():
        jg = jm.embedding.groups[k]
        assert (g.offsets, g.total_rows, g.table_indices) == \
            (jg.offsets, jg.total_rows, jg.table_indices)
    want = jlogical(jm.embedding, jparams["embedding"])
    got = pm.embedding.logical_tables(pparams["embedding"])
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(v))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hotness,hybrid,tol", [
    ("f32", 1, False, 1e-5), ("bf16", 1, False, 2e-2),
    ("f32", 3, False, 1e-5), ("bf16", 3, False, 2e-2),
    ("f32", 3, True, 1e-5), ("bf16", 1, True, 2e-2)])
def test_forward_matches_jax_kernels(dtype, hotness, hybrid, tol):
    mesh, jm, jparams, pm, pparams = _pair(dtype, hotness, hybrid)
    batch = _batches(jm.cfg, 1)[0]
    with mesh:
        want = np.asarray(jax.jit(jm.apply)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = pm.apply(pparams, put_batch(batch, "cpu")).numpy()
    assert got.shape == want.shape == (BATCH,)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_dense_optimizers_match_jax(name):
    rng = np.random.default_rng(3)
    shapes = {"a": {"w0": (7, 5), "b0": (5,)}, "b": {"w": (3, 4)}}
    make = lambda: {k: {kk: rng.standard_normal(s).astype(np.float32)
                        for kk, s in v.items()} for k, v in shapes.items()}
    params, grads1, grads2 = make(), make(), make()
    jc = JTrainConfig(learning_rate=1e-2, weight_decay=0.1)
    pc = TrainConfig(learning_rate=1e-2, weight_decay=0.1)
    jo, po = jopt.make(name, jc), popt.make(name, pc)
    jp, js = params, jo.init(params)
    tp = convert.state_from_flat(jflatten(params), device="cpu")
    ps = po.init(tp)
    for g in (grads1, grads2):
        jg, jnorm = jopt.clip_by_global_norm(g, 1.0)
        pg, pnorm = popt.clip_by_global_norm(
            convert.state_from_flat(jflatten(g), device="cpu"), 1.0)
        assert abs(float(pnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
        jp, js = jo.update(jg, js, jp)
        tp, ps = po.update(pg, ps, tp)
    for k, v in _np({"p": jp, "s": js}).items():
        np.testing.assert_allclose(
            convert.state_to_flat({"p": tp, "s": ps})[k], v,
            rtol=1e-6, atol=1e-6)


def test_rowwise_adagrad_matches_jax_and_keeps_untouched_rows():
    rng = np.random.default_rng(4)
    p = {"t": {"dp": rng.standard_normal((50, 8)).astype(np.float32)}}
    g = {"t": {"dp": rng.standard_normal((50, 8)).astype(np.float32)}}
    g["t"]["dp"][10:20] = 0.0
    jo = jsparse.make_sparse("rowwise_adagrad", JTrainConfig(1e-2))
    po = psparse.make_sparse("rowwise_adagrad", TrainConfig(1e-2))
    js = jo.init(p)
    tp = convert.state_from_flat(jflatten(p), device="cpu")
    ps = po.init(tp)
    for _ in range(2):
        p, js = jo.update(g, js, p)
        tp, ps = po.update(
            convert.state_from_flat(jflatten(g), device="cpu"), ps, tp)
    got = convert.state_to_flat({"p": tp, "s": ps})
    for k, v in _np({"p": p, "s": js}).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6)
    start = rng.standard_normal((50, 8)).astype(np.float32)
    tp = {"t": {"dp": torch.from_numpy(start)}}
    zero = {"t": {"dp": torch.zeros(50, 8)}}
    new, st = po.update(zero, po.init(tp), tp)
    assert torch.equal(new["t"]["dp"], torch.from_numpy(start))
    assert torch.equal(st["acc"]["t"]["dp"], torch.zeros(50))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,microbatches,hybrid", [
    ("f32", 1, False), ("f32", 2, False), ("bf16", 1, False),
    ("f32", 1, True)])
def test_train_steps_match_jax(dtype, microbatches, hybrid):
    mesh, jm, jparams, pm, pparams = _pair(dtype, hybrid=hybrid)
    jcfg = JTrainConfig(learning_rate=1e-2, weight_decay=0.01,
                        microbatches=microbatches)
    pcfg = TrainConfig(learning_rate=1e-2, weight_decay=0.01,
                       microbatches=microbatches)
    with mesh:
        jopt_state = jts.init_opt_state(jparams, jcfg)
        jstep = jax.jit(jts.build_train_step(jm, jcfg))
    # the port starts from the JAX-exported optimizer state too
    popt_state = convert.state_from_flat(jflatten(jopt_state),
                                         device="cpu")
    pstep = pts.build_train_step(pm, pcfg)
    jl, pl = [], []
    for batch in _batches(jm.cfg, 5, seed=2):
        with mesh:
            jparams, jopt_state, jmet = jstep(
                jparams, jopt_state,
                {k: jnp.asarray(v) for k, v in batch.items()})
        pparams, popt_state, pmet = pstep(pparams, popt_state,
                                          put_batch(batch, "cpu"))
        jl.append(float(jmet["loss"]))
        pl.append(float(pmet["loss"]))
    if dtype == "bf16":
        np.testing.assert_allclose(pl, jl, rtol=2e-2, atol=2e-2)
        return
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    want = _np({"params": jexport(jm, jparams), "opt": jopt_state})
    got = convert.state_to_flat({"params": export_logical_params(
        pm, pparams), "opt": popt_state})
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints and the trainer
# ---------------------------------------------------------------------------

def _trainers(ckpt_dir_j, ckpt_dir_p, ckpt_interval=1):
    jcfg, pcfg = _cfgs("f32")
    mesh = make_test_mesh((1, 1))
    with mesh:
        jm = JModel(jcfg, mesh, global_batch=BATCH)
    pm = RecsysModel(pcfg, device="cpu", global_batch=BATCH)
    data = JSynthetic(jcfg, BATCH, seed=4).batch
    jt = JTrainer(jm, JTrainConfig(learning_rate=1e-2), mesh, data,
                  ckpt_dir=ckpt_dir_j, ckpt_interval=ckpt_interval)
    pt = Trainer(pm, TrainConfig(learning_rate=1e-2), data,
                 ckpt_dir=ckpt_dir_p, ckpt_interval=ckpt_interval)
    return mesh, jt, pt


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """One package trains 3 steps and checkpoints; both resume from that
    checkpoint to step 5 and must agree on the resumed losses."""
    first = tmp_path / "first"
    mesh, jt, pt = _trainers(str(first), str(first))
    if writer == "port":
        pt.train(3)
    else:
        with mesh:
            jt.train(3)
    for d in ("j", "p"):
        shutil.copytree(first, tmp_path / d)
    mesh, jt, pt = _trainers(str(tmp_path / "j"), str(tmp_path / "p"))
    with mesh:
        jh = jt.train(5)["history"]
    ph = pt.train(5)["history"]
    assert [h["step"] for h in jh] == [h["step"] for h in ph] == [3, 4]
    np.testing.assert_allclose([h["loss"] for h in ph],
                               [h["loss"] for h in jh], rtol=1e-5, atol=1e-5)


def test_failure_replays_to_the_same_loss(tmp_path):
    _, _, clean = _trainers(None, str(tmp_path / "clean"), ckpt_interval=3)
    want = clean.train(9)["history"]
    _, _, pt = _trainers(None, str(tmp_path / "faulty"), ckpt_interval=3)
    armed = {"on": True}

    def inject(step):
        if step == 7 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected node failure")

    pt.failure_injector = inject
    got = pt.train(9)["history"]
    assert not armed["on"]
    steps = [h["step"] for h in got]
    assert steps == list(range(7)) + [7, 8]
    assert got[-1]["loss"] == want[-1]["loss"]


def test_a_step_that_fails_again_after_replay_raises(tmp_path):
    _, _, pt = _trainers(None, str(tmp_path / "c"), ckpt_interval=2)

    def inject(step):
        if step == 3:
            raise RuntimeError("persistent fault")

    pt.failure_injector = inject
    with pytest.raises(RuntimeError, match="persistent fault"):
        pt.train(6)
