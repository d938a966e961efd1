"""Model-parallel training on a mesh: the port against the JAX package.

The port runs as four ``gloo`` ranks (one process a device, spawned with
``torch.multiprocessing`` on a ``FileStore``), the reference as its own
tests run it: one subprocess with four forced host devices
(``--xla_force_host_platform_device_count=4``, ``tests/test_mp_train.py``).
Both start from the same numpy tables and one JAX-exported init, run every
case once in a module fixture (concurrently; each writes ``.npz`` results
and waits, with a time limit, for the files it needs from the other), and
the tests compare:

* ``_bucket_by_owner`` (skewed ids that overflow included),
  ``masked_range_lookup``, ``choose_comm`` / ``plan``: equal to JAX's;
* the three strategies on (2, 2) (``distributed_ag_rs`` also with
  ``shard_axes="model"``, the hybrid split on the all-to-all): pooled
  outputs and table gradients against the reference's ``shard_map`` run,
  f32 <= 1e-5, the all-to-all and localized outputs bit-exact;
* 5 ``Model.fit`` steps on (2, 2) for dlrm (planner groups), wdl (tables
  pinned distributed, all-gather + reduce-scatter) and twotower (pinned,
  all-to-all) in the configs' own dtype (bf16): losses and every logical
  parameter against JAX's (2, 2) run and the port's own
  one-device run, <= 1e-5 (a bf16 layer's weight gradients round after
  their sum over the ranks, as XLA's do);
* manual mode (bf16, with the bf16 gradient all-reduce) against gspmd and
  JAX's manual run, <= 5e-3 (the reference's bar);
* checkpoints: a (2, 2) save resumes on (1, 1) and (4, 1) bit-exactly in
  the port, and crosses packages both ways bit for bit; the trainer's
  checkpoint (optimizer state included) resumes on (2, 2) and (4, 1);
* an N-group model (neumf) fit -> deploy -> serve on the mesh;
* the reference's Solver and compile rejections, ``batch_shardings`` and
  the train launcher on the mesh.

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

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
BATCH = 32
STEPS = 5
#: f32 sum order; manual mode's bf16 all-reduce (the reference's bar)
TOL = 1e-5
MANUAL_TOL = 5e-3
#: the module's processes: ranks and the JAX subprocess
TIMEOUT_S = 420

#: fit cases: (recipe module, pinned strategy, comm, mode, all-reduce,
#: compute dtype; None: the config's own)
FITS = {
    "dlrm": ("dlrm_criteo", None, "auto", "gspmd", "f32", None),
    "wdl": ("wdl_criteo", "distributed", "allgather_rs", "gspmd", "f32",
            None),
    "twotower": ("twotower_criteo", "distributed", "all_to_all", "gspmd",
                 "f32", None),
    "manual": ("dlrm_criteo", None, "auto", "manual", "bf16", None),
}
#: strategy cases: (strategy, comm, shard_axes)
STRATS = {
    "ag_rs": ("distributed", "allgather_rs", "all"),
    "ag_rs_model": ("distributed", "allgather_rs", "model"),
    "a2a": ("distributed", "all_to_all", "all"),
    "localized": ("localized", "allgather_rs", "all"),
    "hybrid_a2a": ("hybrid", "all_to_all", "all"),
}


def _tables(table_cls, strategy, n=4, vocab=64, dim=8, hotness=3):
    return [table_cls(f"t{i}", vocab + 8 * i, dim, hotness=hotness,
                      strategy=strategy, hot_fraction=0.25)
            for i in range(n)]


def _ids(seed, tabs, b=16):
    rng = np.random.default_rng(seed)
    h = max(t.hotness for t in tabs)
    return np.stack([rng.integers(-1, t.vocab_size, (b, h))
                     for t in tabs], axis=1).astype(np.int32)


def _fit_cfg(pkg_cfg, case):
    """The smoke config of a fit case: its tables pinned to the case's
    strategy, in the case's dtype."""
    _, strategy, _, _, _, dtype = FITS[case]
    cfg = pkg_cfg if dtype is None else dataclasses.replace(pkg_cfg,
                                                            dtype=dtype)
    if strategy is not None:
        cfg = dataclasses.replace(cfg, tables=tuple(
            dataclasses.replace(t, strategy=strategy) for t in cfg.tables))
    return cfg


def _solver_kw(case):
    _, _, comm, mode, ar, _ = FITS[case]
    return dict(batch_size=BATCH, lr=1e-2, weight_decay=0.01, comm=comm,
                mode=mode, grad_allreduce_dtype=ar)


def _data(d):
    return np.load(d, allow_pickle=False)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _rank_entry(rank, world, store_path, tmp, err_dir):
    """One gloo rank: join the group, run every port case, write results
    (rank 0) and, on an error, its traceback."""
    try:
        torch.set_num_threads(2)
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


def _save(rank, tmp, name, arrays):
    if rank == 0:
        np.savez(os.path.join(tmp, f"port_{name}.npz"), **arrays)


def _wait_for(path, limit_s=TIMEOUT_S - 60):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > limit_s:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _port_model(case, mesh_shape, init, *, device_mesh=None):
    """The compiled port graph of a fit case, its f32 (pinned) config
    and the JAX-exported init imported onto its mesh."""
    import importlib
    from repro_torch import api, convert
    from repro_torch.models.recsys.model import (
        RecsysModel, import_logical_params)
    mod = importlib.import_module(f"repro_torch.configs.{FITS[case][0]}")
    p = mod.build_model(smoke=True, solver=api.Solver(
        mesh_shape=mesh_shape, **_solver_kw(case)), mesh=device_mesh)
    p.compile(device="cpu")
    cfg = _fit_cfg(p.cfg, case)
    p.cfg = cfg
    p._model = RecsysModel(cfg, device="cpu", global_batch=BATCH,
                           mesh=p.mesh, comm=FITS[case][2])
    p._params = import_logical_params(p.model, convert.state_from_flat(
        dict(init), device="cpu"))
    return p


def _port_cases(rank, tmp):
    import torch.distributed as dist
    from repro_torch import api, convert
    from repro_torch.configs.base import EmbeddingTableConfig
    from repro_torch.core.embedding.collection import EmbeddingCollection
    from repro_torch.core.embedding.strategies import all_gather
    from repro_torch.data.pipeline import batch_shardings
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import build_server_from_config
    from repro_torch.models.recsys.model import export_logical_params
    mesh = meshlib.make_test_mesh((2, 2))
    dp_group = meshlib.axis_group(mesh, ("data",))

    # -- the strategies: pooled outputs and table gradients ------------------
    for name, (strategy, comm, shard_axes) in STRATS.items():
        inp = _data(os.path.join(tmp, f"in_strat_{name}.npz"))
        tabs = _tables(EmbeddingTableConfig, strategy)
        coll = EmbeddingCollection(tabs, mesh=mesh, comm=comm,
                                   shard_axes=shard_axes, device="cpu",
                                   use_kernels=True)
        params = coll.import_logical({k[2:]: inp[k] for k in inp.files
                                      if k.startswith("p_")})
        params = {k: v.requires_grad_() for k, v in params.items()}
        blk = batch_shardings(mesh)["cat"]
        ids = torch.from_numpy(blk.take(inp["ids"]))
        cot = torch.from_numpy(blk.take(inp["cot"]))
        out = coll.lookup(params, ids)
        ((out * cot).sum() / 2).backward()        # 2 model replicas a row
        grads = {}
        for k, v in params.items():
            g = v.grad.clone()
            axes = coll.replica_axes(k)
            if axes is None or axes:        # summed over its replicas
                dist.all_reduce(g, group=None if axes is None else
                                meshlib.axis_group(mesh, axes))
            grads.update(coll.export_logical({k: g}))
        full = all_gather(out.detach(), dp_group)
        _save(rank, tmp, f"strat_{name}", {
            "out": full.numpy(), **{f"g_{k}": v.numpy()
                                    for k, v in grads.items()}})

    # -- batch_shardings: this rank's data-parallel block --------------------
    blk = batch_shardings(mesh)
    got = torch.tensor([blk["cat"].index, blk["cat"].count], dtype=torch.int64)
    allb = [torch.zeros_like(got) for _ in range(WORLD)]
    dist.all_gather(allb, got)
    _save(rank, tmp, "shardings", {"blocks": torch.stack(allb).numpy()})

    # -- fits on (2, 2) -----------------------------------------------------
    for case in FITS:
        _wait_for(os.path.join(tmp, f"in_fit_{case}.npz"))
        init = _data(os.path.join(tmp, f"in_fit_{case}.npz"))
        p = _port_model(case, (2, 2), init)
        data = SyntheticCTR(p.cfg, BATCH, seed=4).batch
        hist = p.fit(data, steps=STEPS)
        flat = convert.state_to_flat(export_logical_params(p.model,
                                                           p.params))
        _save(rank, tmp, f"fit_{case}", {
            "losses": np.asarray([h["loss"] for h in hist]),
            **{f"p/{k}": v for k, v in flat.items()}})

    # -- N groups: neumf fit -> save -> deploy -> serve on the mesh ----------
    from repro_torch.configs import neumf_criteo
    m = neumf_criteo.build_model(smoke=True, solver=api.Solver(
        batch_size=BATCH, lr=1e-2, mesh_shape=(2, 2)))
    m.compile(device="cpu")
    m.fit(steps=3)
    b = SyntheticCTR(m.cfg, 8).batch(0)
    p_mp = m.predict(b)
    ck = os.path.join(tmp, "port_ckpt")
    m.save(ck)
    dep = os.path.join(tmp, "port_dep")
    server = m.deploy(dep, cache_capacity=256)
    res = {"p_mp": p_mp}
    if rank == 0:
        res["live"] = server.predict(b["dense"], b["cat"])
        srv, _ = build_server_from_config(os.path.join(dep, "ps.json"),
                                          device="cpu")
        res["rebuilt"] = srv.predict(b["dense"], b["cat"])
    # the (2, 2) checkpoint onto (4, 1) and (1, 1) (rank 0 alone)
    m4 = api.Model.load(ck, mesh=meshlib.make_test_mesh((4, 1)))
    res["p_41"] = m4.predict(b)
    one = meshlib.make_test_mesh((1, 1))
    if meshlib.in_mesh(one):
        m1 = api.Model.load(ck, mesh=one)
        res["p_11"] = m1.predict(b)
        res["resumed"] = np.asarray([h["loss"] for h in m1.fit(steps=2)])
    # the reference's (2, 2) checkpoint (its dlrm fit's) in the port, on
    # (4, 1)
    jck = os.path.join(tmp, "jax_ckpt")
    _wait_for(os.path.join(tmp, "jax_ckpt.done"))
    mj = api.Model.load(jck, mesh=meshlib.make_test_mesh((4, 1)))
    for k, v in convert.state_to_flat(export_logical_params(
            mj.model, mj.params)).items():
        res[f"jck/{k}"] = v
    _save(rank, tmp, "ckpt", res)

    # -- the trainer's checkpoint resumes on the mesh and on another one ----
    init = _data(os.path.join(tmp, "in_fit_twotower.npz"))
    data = SyntheticCTR(_port_model("twotower", (2, 2), init).cfg, BATCH,
                        seed=4).batch
    ck, ck41 = os.path.join(tmp, "trainer_ckpt"), \
        os.path.join(tmp, "trainer_ckpt41")
    _port_model("twotower", (2, 2), init).fit(data, steps=2, ckpt_dir=ck)
    if rank == 0:
        import shutil
        shutil.copytree(ck, ck41)
    dist.barrier()
    resumed = _port_model("twotower", (2, 2), init).fit(data, steps=4,
                                                         ckpt_dir=ck)
    resumed41 = _port_model("twotower", (4, 1), init).fit(data, steps=4,
                                                           ckpt_dir=ck41)
    whole = _port_model("twotower", (2, 2), init).fit(data, steps=4)
    _save(rank, tmp, "trainer_resume", {
        "resumed": [h["loss"] for h in resumed],
        "resumed41": [h["loss"] for h in resumed41],
        "whole": [h["loss"] for h in whole]})

    # -- rejections at compile (the reference's GraphErrors) -----------------
    from repro_torch.configs import dlrm_criteo
    msgs = {}
    try:
        dlrm_criteo.build_model(smoke=True, solver=api.Solver(
            batch_size=30, mesh_shape=(4, 1))).compile(device="cpu")
    except api.GraphError as e:
        msgs["batch"] = str(e)
    loc = api.Model(api.Solver(batch_size=32, mesh_shape=(2, 2)),
                    api.DataReaderParams(num_dense_features=4),
                    name="loc-bad")
    loc.add(api.Input(dense_dim=4))
    loc.add(api.SparseEmbedding(vocab_sizes=[64, 64, 64], dim=8,
                                strategy="localized", top_name="emb"))
    loc.add(api.DenseLayer("concat", ["dense", "emb"], ["flat"]))
    loc.add(api.DenseLayer("mlp", ["flat"], ["logit"], units=(1,)))
    loc.add(api.DenseLayer("sigmoid", ["logit"], ["prob"]))
    try:
        loc.compile(device="cpu")
    except api.GraphError as e:
        msgs["localized"] = str(e)

    # -- the train launcher on the mesh --------------------------------------
    hist = launch_train.main([
        "--arch", "dlrm-criteo", "--smoke", "--device", "cpu", "--steps",
        "3", "--batch", "32", "--lr", "1e-2", "--mesh", "2x2", "--mode",
        "manual", "--grad-ar-dtype", "bf16", "--comm", "all_to_all",
        "--log-every", "100"])
    ref = dlrm_criteo.build_model(smoke=True, solver=api.Solver(
        batch_size=32, lr=1e-2, mesh_shape=(2, 2), mode="manual",
        grad_allreduce_dtype="bf16", comm="all_to_all"))
    ref.compile(device="cpu")
    want = [h["loss"] for h in ref.fit(steps=3)]
    if rank == 0:
        with open(os.path.join(tmp, "port_misc.json"), "w") as f:
            json.dump({"msgs": msgs,
                       "launcher": [h["loss"] for h in hist],
                       "launcher_want": want}, f)


# ---------------------------------------------------------------------------
# the reference's subprocess
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import os, sys, time, json, dataclasses, importlib
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import numpy as np
import jax, jax.numpy as jnp
from repro import api as japi
from repro.configs.base import EmbeddingTableConfig
from repro.core.embedding import EmbeddingCollection
from repro.data.synthetic import SyntheticCTR
from repro.launch.mesh import make_test_mesh
from repro.models.recsys.model import (RecsysModel, export_logical_params,
                                       import_logical_params)
from repro.train.checkpoint import flatten_tree, unflatten_like

tmp = sys.argv[1]
# the test module's cases and helpers, without importing torch here
exec(sys.argv[2])

def load(name):
    return dict(np.load(os.path.join(tmp, name)))

# each fit case's init, exported logical (as the checkpoint holds it)
one = make_test_mesh((1, 1))
inits = {}
for case, (modname, _, comm, _, _, _) in FITS.items():
    if case == "manual":      # manual mode starts where gspmd dlrm does
        flat = inits["dlrm"]
    else:
        mod = importlib.import_module(f"repro.configs.{modname}")
        j = mod.build_model(smoke=True,
                            solver=japi.Solver(**_solver_kw(case)))
        cfg = _fit_cfg(j.to_recsys_config(), case)
        with one:
            jm = RecsysModel(cfg, one, global_batch=BATCH, comm=comm)
            key = list(FITS).index(case)
            flat = flatten_tree(export_logical_params(
                jm, jax.jit(jm.init)(jax.random.PRNGKey(key))))
        inits[case] = flat
    np.savez(os.path.join(tmp, f"in_fit_{case}.tmp.npz"),
             **{k: np.asarray(v) for k, v in flat.items()})
    os.rename(os.path.join(tmp, f"in_fit_{case}.tmp.npz"),
              os.path.join(tmp, f"in_fit_{case}.npz"))

mesh = make_test_mesh((2, 2))
# the strategies
for name, (strategy, comm, shard_axes) in STRATS.items():
    inp = load(f"in_strat_{name}.npz")
    tabs = _tables(EmbeddingTableConfig, strategy)
    with mesh:
        coll = EmbeddingCollection(tabs, mesh, comm=comm,
                                   shard_axes=shard_axes)
        params = coll.import_logical({k[2:]: jnp.asarray(v)
                                      for k, v in inp.items()
                                      if k.startswith("p_")})
        ids, cot = jnp.asarray(inp["ids"]), jnp.asarray(inp["cot"])

        def f(p):
            out = coll.lookup(p, ids)
            return (out * cot).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            params)
        grads = coll.export_logical(grads)
    np.savez(os.path.join(tmp, f"jax_strat_{name}.npz"),
             out=np.asarray(out),
             **{f"g_{k}": np.asarray(v) for k, v in grads.items()})

# the fits
for case, (modname, _, comm, _, _, _) in FITS.items():
    init = load(f"in_fit_{case}.npz")
    mod = importlib.import_module(f"repro.configs.{modname}")
    j = mod.build_model(smoke=True, solver=japi.Solver(
        mesh_shape=(2, 2), **_solver_kw(case)))
    j.compile()
    cfg = _fit_cfg(j.cfg, case)
    j.cfg = cfg
    with j.mesh:
        j._model = RecsysModel(cfg, j.mesh, global_batch=BATCH, comm=comm)
        dummy = jax.eval_shape(lambda: export_logical_params(
            j._model, j._model.init(jax.random.PRNGKey(0))))
        j._params = import_logical_params(j._model, unflatten_like(
            dummy, {k: jnp.asarray(v) for k, v in init.items()}))
    data = SyntheticCTR(cfg, BATCH, seed=4).batch
    hist = j.fit(data, steps=STEPS)
    if case == "dlrm":            # a (2, 2) checkpoint for the port
        j.save(os.path.join(tmp, "jax_ckpt"))
        open(os.path.join(tmp, "jax_ckpt.done"), "w").close()
    with j.mesh:
        flat = flatten_tree(export_logical_params(j._model, j._params))
    np.savez(os.path.join(tmp, f"jax_fit_{case}.npz"),
             losses=np.asarray([h["loss"] for h in hist]),
             **{f"p/{k}": np.asarray(v) for k, v in flat.items()})

# the port's (2, 2) checkpoint in the reference, on (1, 1) and (4, 1)
t0 = time.time()
while not os.path.exists(os.path.join(tmp, "port_ckpt.npz")):
    if time.time() - t0 > 300:
        raise SystemExit("the port's checkpoint never appeared")
    time.sleep(0.2)
out = {}
for shape in ((1, 1), (4, 1)):
    mj = japi.Model.load(os.path.join(tmp, "port_ckpt"),
                         mesh=make_test_mesh(shape))
    b = SyntheticCTR(mj.cfg, 8).batch(0)
    out[f"pred_{shape[0]}{shape[1]}"] = mj.predict(b)
    with mj.mesh:
        flat = flatten_tree(export_logical_params(mj._model, mj._params))
    for k, v in flat.items():
        out[f"{shape[0]}{shape[1]}/{k}"] = np.asarray(v)
np.savez(os.path.join(tmp, "jax_ckpt_in.npz"), **out)
print("JAX_OK")
"""


# ---------------------------------------------------------------------------
# the module fixture: inputs, then both packages at once
# ---------------------------------------------------------------------------

def _write_inputs(tmp):
    """The strategies' numpy tables, ids and cotangents (the fit cases'
    inits come from the reference's subprocess)."""
    from repro_torch.configs.base import EmbeddingTableConfig
    from repro_torch.core.embedding.collection import EmbeddingCollection
    for i, (name, (strategy, comm, _)) in enumerate(STRATS.items()):
        tabs = _tables(EmbeddingTableConfig, strategy)
        coll = EmbeddingCollection(tabs, comm=comm, device="cpu")
        logical = coll.export_logical(
            coll.init(torch.Generator().manual_seed(10 + i)))
        ids = _ids(20 + i, tabs)
        cot = np.random.default_rng(30 + i).standard_normal(
            (ids.shape[0], len(tabs), 8)).astype(np.float32)
        np.savez(os.path.join(tmp, f"in_strat_{name}.npz"), ids=ids,
                 cot=cot, **{f"p_{k}": v.numpy() for k, v in
                             logical.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("mp_train"))
    err_dir = os.path.join(tmp, "errors")
    os.makedirs(err_dir)
    _write_inputs(tmp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    log = open(os.path.join(tmp, "jax.log"), "w")
    import inspect
    shared = "\n".join(
        [f"BATCH, STEPS = {BATCH}, {STEPS}", f"FITS = {FITS!r}",
         f"STRATS = {STRATS!r}", "import dataclasses"]
        + [inspect.getsource(f) for f in (_tables, _fit_cfg, _solver_kw)])
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
    failed = []
    for p in ranks:
        p.join(max(1.0, deadline - time.time()))
    for r, p in enumerate(ranks):
        if p.is_alive() or p.exitcode != 0:
            failed.append(r)
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
    return dict(np.load(os.path.join(tmp, name)))


# ---------------------------------------------------------------------------
# functions held directly (no mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "skewed"])
def test_bucket_by_owner_matches_jax(skew):
    import jax.numpy as jnp
    from repro.core.embedding.strategies import _bucket_by_owner as jb
    from repro_torch.core.embedding.strategies import (
        _bucket_by_owner, a2a_capacity)
    rng = np.random.default_rng(7)
    flat = rng.integers(-1, 500, 96).astype(np.int32)
    if skew:                                  # one owner takes most ids
        flat[:60] = 4 * rng.integers(0, 100, 60)
    n = 4
    cap = a2a_capacity(flat.size, n, 1.0 if skew else 2.0)
    want = [np.asarray(x) for x in jb(jnp.asarray(flat), n, cap)]
    got = [x.numpy() for x in _bucket_by_owner(torch.from_numpy(flat), n,
                                               cap)]
    if skew:
        assert not want[2][flat >= 0].all()   # some ids overflow
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.astype(w.dtype), w)


def test_masked_range_lookup_matches_jax():
    import jax.numpy as jnp
    from repro.core.embedding.common import masked_range_lookup as jm
    from repro_torch.core.embedding.common import masked_range_lookup
    from repro_torch.kernels.ops import kernel_pool
    rng = np.random.default_rng(3)
    local = rng.standard_normal((40, 8)).astype(np.float32)
    rows = rng.integers(-1, 160, (6, 3, 4)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(local), jnp.asarray(rows), 80))
    for fn in (None, kernel_pool):
        got = masked_range_lookup(torch.from_numpy(local),
                                  torch.from_numpy(rows), 80, pool_fn=fn)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_choose_comm_and_plan_match_jax():
    from repro.configs.base import EmbeddingTableConfig as JT
    from repro.configs.base import MeshConfig as JMesh
    from repro.core.embedding import planner as jp
    from repro_torch.configs.base import EmbeddingTableConfig, MeshConfig
    from repro_torch.core.embedding import planner as pp
    specs = [(100, 8, 1), (70000, 16, 1), (2 ** 20, 128, 1),
             (300000, 64, 3), (5000000, 32, 1)]
    for picks in ([0], [1], [2], [1, 2], [3], [2, 3], [4], []):
        jt = [JT(f"t{i}", *specs[i][:2], hotness=specs[i][2])
              for i in picks]
        pt = [EmbeddingTableConfig(f"t{i}", *specs[i][:2],
                                   hotness=specs[i][2]) for i in picks]
        for thr in (65536, 1 << 22):
            assert pp.choose_comm(pt, threshold=thr) == \
                jp.choose_comm(jt, threshold=thr)
    jt = [JT(f"t{i}", v, d, hotness=h) for i, (v, d, h) in enumerate(specs)]
    pt = [EmbeddingTableConfig(f"t{i}", v, d, hotness=h)
          for i, (v, d, h) in enumerate(specs)]
    for shape in ((1, 1), (2, 2), (4, 1), (8, 16)):
        for batch in (64, 4096, 65536):
            want = jp.plan(jt, JMesh(shape, ("data", "model")), batch)
            got = pp.plan(pt, MeshConfig(shape, ("data", "model")), batch)
            assert {k: (v.strategy, v.comm_bytes, v.mem_bytes)
                    for k, v in got.items()} == \
                {k: (v.strategy, v.comm_bytes, v.mem_bytes)
                 for k, v in want.items()}


# ---------------------------------------------------------------------------
# on the mesh, against the reference's runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STRATS))
def test_strategies_match_jax_shard_map(runs, name):
    want = _load(runs, f"jax_strat_{name}.npz")
    got = _load(runs, f"port_strat_{name}.npz")
    assert set(got) == set(want)
    exact = STRATS[name][1] == "all_to_all" or STRATS[name][0] == "localized"
    if exact:
        np.testing.assert_array_equal(got["out"], want["out"])
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_batch_shardings_take_the_data_block(runs):
    blocks = _load(runs, "port_shardings.npz")["blocks"]
    # rank r = (data r // 2, model r % 2): block `data` of 2
    np.testing.assert_array_equal(blocks, [[0, 2], [0, 2], [1, 2], [1, 2]])


@pytest.mark.parametrize("case", ["dlrm", "wdl", "twotower"])
def test_fit_on_a_mesh_matches_jax_and_one_device(runs, case):
    from repro_torch import convert
    from repro_torch.models.recsys.model import export_logical_params
    want = _load(runs, f"jax_fit_{case}.npz")
    got = _load(runs, f"port_fit_{case}.npz")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL,
                               atol=TOL)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                   err_msg=k)
    # the port's own one-device run from the same init
    from repro_torch.data.synthetic import SyntheticCTR
    init = _load(runs, f"in_fit_{case}.npz")
    p = _port_model(case, None, init)
    assert p.mesh is None
    hist = p.fit(SyntheticCTR(p.cfg, BATCH, seed=4).batch, steps=STEPS)
    np.testing.assert_allclose([h["loss"] for h in hist], got["losses"],
                               rtol=TOL, atol=TOL)
    flat = convert.state_to_flat(export_logical_params(p.model, p.params))
    for k, v in flat.items():
        np.testing.assert_allclose(got[f"p/{k}"], v, rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_manual_bf16_allreduce_tracks_gspmd_and_jax(runs):
    got = _load(runs, "port_fit_manual.npz")["losses"]
    want = _load(runs, "jax_fit_manual.npz")["losses"]
    gspmd = _load(runs, "port_fit_dlrm.npz")["losses"]
    np.testing.assert_allclose(got, want, rtol=MANUAL_TOL, atol=MANUAL_TOL)
    np.testing.assert_allclose(got, gspmd, rtol=MANUAL_TOL, atol=MANUAL_TOL)
    assert not np.array_equal(got, gspmd)    # the bf16 sum is in the path


def test_checkpoint_resumes_across_mesh_sizes(runs):
    got = _load(runs, "port_ckpt.npz")
    np.testing.assert_array_equal(got["p_41"], got["p_mp"])
    np.testing.assert_array_equal(got["p_11"], got["p_mp"])
    assert np.isfinite(got["resumed"]).all()


def test_checkpoints_cross_packages_both_ways(runs):
    from repro.train import checkpoint as jck
    got = _load(runs, "port_ckpt.npz")
    # the reference's (2, 2) checkpoint, loaded by the port on (4, 1)
    flat, _ = jck.load(os.path.join(runs, "jax_ckpt"),
                       jck.latest_step(os.path.join(runs, "jax_ckpt")))
    params = {k[len("params/"):]: v for k, v in flat.items()}
    assert {k[len("jck/"):] for k in got if k.startswith("jck/")} == \
        set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[f"jck/{k}"], v, err_msg=k)
    # the port's (2, 2) checkpoint, loaded by the reference on (1, 1) and
    # (4, 1)
    from repro_torch.train import checkpoint as pck
    pflat, _ = pck.load(os.path.join(runs, "port_ckpt"), 0)
    jin = _load(runs, "jax_ckpt_in.npz")
    for shape in ("11", "41"):
        for k, v in pflat.items():
            np.testing.assert_array_equal(
                jin[f"{shape}/{k[len('params/'):]}"], v, err_msg=k)
    np.testing.assert_array_equal(jin["pred_11"], jin["pred_41"])


def test_trainer_checkpoint_resumes_on_any_mesh(runs):
    """The trainer's checkpoint (logical tables, the row-wise optimizer
    state in the reference's physical layout) written on (2, 2) after 2
    steps: resumed on (2, 2) and on (4, 1), steps 2-3 give the
    uninterrupted run's losses (the (2, 2) resume bit for bit)."""
    got = _load(runs, "port_trainer_resume.npz")
    np.testing.assert_array_equal(got["resumed"], got["whole"][2:])
    np.testing.assert_allclose(got["resumed41"], got["whole"][2:],
                               rtol=TOL, atol=TOL)


def test_ngroup_fit_deploy_serve_on_the_mesh(runs):
    got = _load(runs, "port_ckpt.npz")
    np.testing.assert_array_equal(got["live"], got["p_mp"])
    np.testing.assert_array_equal(got["rebuilt"], got["p_mp"])


def test_compile_rejections_name_axis_and_group(runs):
    with open(os.path.join(runs, "port_misc.json")) as f:
        msgs = json.load(f)["msgs"]
    assert "batch_size=30" in msgs["batch"] and "4" in msgs["batch"] \
        and "data" in msgs["batch"]
    assert "localized" in msgs["localized"] and "3" in msgs["localized"] \
        and "4" in msgs["localized"]


def test_train_launcher_runs_on_the_mesh(runs):
    with open(os.path.join(runs, "port_misc.json")) as f:
        misc = json.load(f)
    assert len(misc["launcher"]) == 3 and np.isfinite(misc["launcher"]).all()
    np.testing.assert_allclose(misc["launcher"], misc["launcher_want"],
                               rtol=1e-6, atol=1e-6)


def test_solver_rejects_bad_mesh_shapes():
    from repro_torch.api import GraphError, Solver
    for bad in ((0, 2), (), (True, 1)):
        with pytest.raises(GraphError, match="positive ints"):
            Solver(batch_size=8, mesh_shape=bad)
    with pytest.raises(GraphError, match="devices .* visible"):
        Solver(batch_size=8, mesh_shape=(64, 64))
    with pytest.raises(GraphError, match="mode"):
        Solver(batch_size=8, mode="magic")
    with pytest.raises(GraphError, match="comm"):
        Solver(batch_size=8, comm="carrier-pigeon")


def test_oversubscribed_mesh_error_names_the_fix():
    from repro_torch.api import GraphError, Solver
    from repro_torch.launch.mesh import make_test_mesh
    with pytest.raises(GraphError, match="torchrun --nproc-per-node 4096"):
        Solver(batch_size=8, mesh_shape=(64, 64))
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        make_test_mesh((2, 2))
