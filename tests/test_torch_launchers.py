"""The port's front doors against the reference's, on the CPU: the paper
recipes' modules and ``Model.summary``, ``deploy_from_training``,
``FrequencyStats`` / ``apply_remap``, ``Prefetcher``, and the three
command lines (``launch.loadtest``, ``launch.serve``, the recsys branch
of ``launch.train``), each run in process with ``--device cpu`` at smoke
sizes.

- All seven recipes' ``build_model`` (smoke and full) lower to the
  reference's configs (equal ``recsys_config_hash``), and ``summary()``
  returns the reference's text.
- ``deploy_from_training`` writes the reference's PDB files byte for byte
  for one WDL smoke model (deep tables and their ``*_wide`` twins) from
  one JAX init.
- ``launch.loadtest.main`` in demo mode (a two-model ensemble, a 1 s
  steady phase and a 1 s overload, ``--smoke-assert``) writes an artifact
  whose key tree, model names and histogram bucket keys aside, is the
  one the reference's launcher writes for the same flags (run once, one
  model, in a module fixture; its demo bundle is also the JAX-written
  bundle the serve tests read).
- ``launch.serve.main --sanitize`` on the JAX-written bundle: one host
  sync a served group; ``--payload-dtype int8`` passes the cross-check
  against the f32 rebuild; demo mode for an ensemble and for
  ``twotower-criteo``.
- ``launch.train.main`` for ``dlrm-criteo``: 4 steps with checkpoints,
  then ``--steps 6`` resumes at step 4; the losses equal (within 1e-5)
  6 uninterrupted steps of ``Model.fit``; the checkpoint loads in the
  reference's ``train/checkpoint.py``; ``--mode manual``, ``--comm
  all_to_all`` and ``--grad-ar-dtype bf16`` train on one device as
  ``Model.fit`` does, and ``--mesh 2x1`` in one process raises the
  reference's ``GraphError`` naming ``torchrun`` (the launcher on a mesh
  of four ranks: ``tests/test_torch_mp_train.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses
import importlib
import json
import os

import jax
import numpy as np

from repro import api as japi
from repro.configs import registry as jregistry
from repro.configs.base import recsys_config_hash as jhash
from repro.core.embedding import frequency as jfrequency
from repro.core.hps.persistent_db import PersistentDB as JPDB
from repro.launch import loadtest as jloadtest
from repro.launch.mesh import make_test_mesh
from repro.models.recsys.model import RecsysModel as JModel
from repro.models.recsys.model import export_logical_params as jexport
from repro.serve.server import deploy_from_training as jdeploy
from repro.train import checkpoint as jck
from repro.train.checkpoint import flatten_tree as jflatten

from repro_torch import api, convert
from repro_torch.configs import registry
from repro_torch.configs.base import recsys_config_hash
from repro_torch.core.embedding import FrequencyStats, apply_remap
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.data.pipeline import Prefetcher, batch_shardings, put_batch
from repro_torch.launch import loadtest, serve
from repro_torch.launch import train as launch_train
from repro_torch.models.recsys.model import RecsysModel, import_logical_params
from repro_torch.serve.server import deploy_from_training
from repro_torch.train import checkpoint as ck

ARCHS = sorted(registry.RECSYS_RECIPES)
#: f32 losses of the launcher against ``Model.fit``
LOSS_TOL = 1e-5


def _recipe(pkg_registry, arch):
    return importlib.import_module(pkg_registry.RECSYS_RECIPES[arch])


# ---------------------------------------------------------------------------
# recipes and summary
# ---------------------------------------------------------------------------

def test_recipe_registry_names_the_references_recipes():
    assert sorted(registry.RECSYS_RECIPES) == sorted(jregistry.RECSYS_RECIPES)
    for arch in ARCHS:
        assert _recipe(registry, arch).ARCH_ID == arch


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_recipe_lowers_to_the_references_config(arch, smoke, capsys):
    port = _recipe(registry, arch).build_model(smoke=smoke)
    ref = _recipe(jregistry, arch).build_model(smoke=smoke)
    pcfg, jcfg = port.to_recsys_config(), ref.to_recsys_config()
    assert recsys_config_hash(pcfg) == jhash(jcfg)
    assert port.name == ref.name
    assert pcfg.total_embedding_params == jcfg.total_embedding_params
    assert [t.param_count for t in pcfg.all_tables] == \
        [t.param_count for t in jcfg.all_tables]
    assert port.summary() == ref.summary()


@pytest.mark.parametrize("arch", ["dlrm-criteo", "dcn-criteo",
                                  "deepfm-criteo", "wdl-criteo"])
def test_paper_recipes_lower_onto_the_registry(arch):
    mod = _recipe(registry, arch)
    assert mod.GRAPH_CONFIG == mod.CONFIG == registry.RECSYS_ARCHS[arch]
    # a mesh is carried into the model's compile, as the reference's is
    mesh = object()
    assert mod.build_model(mesh=mesh)._mesh_override is mesh
    assert _recipe(jregistry, arch).build_model(
        mesh=mesh)._mesh_override is mesh


# ---------------------------------------------------------------------------
# deploy_from_training, FrequencyStats, Prefetcher
# ---------------------------------------------------------------------------

def test_deploy_from_training_writes_the_references_pdb(tmp_path):
    jcfg = _recipe(jregistry, "wdl-criteo").build_model(smoke=True) \
        .to_recsys_config()
    pcfg = _recipe(registry, "wdl-criteo").build_model(smoke=True) \
        .to_recsys_config()
    mesh = make_test_mesh((1, 1))
    with mesh:
        jm = JModel(jcfg, mesh, global_batch=64)
        jparams = jm.init(jax.random.PRNGKey(3))
        jdeploy(jm, jparams, JPDB(str(tmp_path / "j")), "wdl")
    pm = RecsysModel(pcfg, device="cpu", global_batch=64)
    pparams = import_logical_params(pm, convert.state_from_flat(
        jflatten(jexport(jm, jparams)), device="cpu"))
    deploy_from_training(pm, pparams, PersistentDB(str(tmp_path / "p")),
                         "wdl")
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p"))
    assert "wdl__C1_wide.f32" in files and "wdl__C6.json" in files
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "p" / f).read_bytes(), f


def test_frequency_stats_equal_the_references():
    rng = np.random.default_rng(7)
    vocabs = [100, 37, 5]
    ids = (rng.zipf(1.3, (400, 3, 2)) - 1) % np.asarray(vocabs)[:, None]
    ids = ids.astype(np.int32)
    ids[rng.random(ids.shape) < 0.1] = -1
    port, ref = FrequencyStats(vocabs), jfrequency.FrequencyStats(vocabs)
    for chunk in np.array_split(ids, 4):
        port.update(chunk)
        ref.update(chunk)
    for t in range(len(vocabs)):
        np.testing.assert_array_equal(port.counts[t], ref.counts[t])
        np.testing.assert_array_equal(port.remap(t), ref.remap(t))
        for frac in (0.0, 0.1, 0.5, 1.0):
            assert port.hot_rows(t, frac) == ref.hot_rows(t, frac)
            assert port.coverage(t, frac) == ref.coverage(t, frac)
    remaps = [port.remap(0), None, port.remap(2)]
    np.testing.assert_array_equal(apply_remap(ids, remaps),
                                  jfrequency.apply_remap(ids, remaps))


def test_frequency_remap_sorts_by_count():
    fs = FrequencyStats([10])
    ids = np.asarray([[[7, 7, 7]], [[7, 2, -1]], [[2, 5, -1]]], np.int32)
    fs.update(ids)
    remap = fs.remap(0)
    assert (remap[7], remap[2], remap[5]) == (0, 1, 2)
    out = apply_remap(ids, [remap])
    assert (out[ids == 7] == 0).all()
    assert (out[ids == -1] == -1).all()


def test_frequency_coverage_estimate():
    fs = FrequencyStats([100])
    rng = np.random.default_rng(0)
    ids = rng.zipf(1.5, (1000, 1, 1)).clip(1, 100).astype(np.int32) - 1
    fs.update(ids)
    cov_10, cov_50 = fs.coverage(0, 0.10), fs.coverage(0, 0.50)
    assert 0 < cov_10 < cov_50 <= 1.0
    assert cov_10 > 0.10          # Zipf: top 10% covers way more than 10%


def test_prefetcher_keeps_order_and_applies_the_transform():
    pf = Prefetcher(iter(range(20)), depth=2, transform=lambda x: 2 * x)
    assert list(pf) == [2 * i for i in range(20)]


def test_prefetcher_raises_the_sources_error_on_next():
    def source():
        yield 1
        yield 2
        raise KeyError("reader failed")

    pf = Prefetcher(source(), depth=4)
    assert next(pf) == 1 and next(pf) == 2
    with pytest.raises(KeyError, match="reader failed"):
        next(pf)


def test_prefetcher_close_stops_the_reader():
    pulled = []

    def source():
        for i in range(10_000):
            pulled.append(i)
            yield i

    pf = Prefetcher(source(), depth=2)
    assert next(pf) == 0
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert len(pulled) < 10


def test_put_batch_and_the_mesh_refusal(tmp_path):
    """A batch onto one device, and onto a (1, 1) mesh of one gloo rank:
    this rank's data-parallel block is the whole batch, the arrays the
    reference's ``put_batch`` places on its (1, 1) mesh (the (2, 2) blocks:
    ``tests/test_torch_mp_train.py``)."""
    import torch.distributed as dist
    from repro.data.pipeline import put_batch as jput
    from repro_torch.launch.mesh import make_test_mesh as pmesh
    rng = np.random.default_rng(0)
    batch = {"dense": rng.normal(size=(4, 3)),
             "cat": rng.integers(0, 9, (4, 2, 1)),
             "label": np.ones(4, np.float32)}
    out = put_batch(batch, "cpu")
    assert (out["dense"].dtype, out["cat"].dtype, out["label"].dtype) == \
        (torch.float32, torch.int32, torch.float32)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = pmesh((1, 1))
        blocks = batch_shardings(mesh)
        assert {(b.index, b.count) for b in blocks.values()} == {(0, 1)}
        got = put_batch(batch, "cpu", mesh)
    finally:
        dist.destroy_process_group()
    want = jput({"dense": batch["dense"].astype(np.float32),
                 "cat": batch["cat"].astype(np.int32),
                 "label": batch["label"]}, make_test_mesh((1, 1)))
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# launch.loadtest
# ---------------------------------------------------------------------------

#: the load test's flags at smoke size, the same for both packages
LOADTEST_FLAGS = ["--train-steps", "1", "--rows", "4", "--qps", "10",
                  "--duration", "1", "--slo-ms", "500", "--queue-depth",
                  "16", "--overload-qps", "3000", "--overload-duration",
                  "1", "--seed", "3"]


@pytest.fixture(scope="module")
def reference_loadtest(tmp_path_factory):
    """The reference's launcher once, one model: its artifact and its demo
    bundle (a bundle written by the JAX package)."""
    root = tmp_path_factory.mktemp("jax_loadtest")
    artifact = str(root / "loadtest.json")
    jloadtest.main(["--arch", "dlrm-criteo", *LOADTEST_FLAGS,
                    "--deploy-dir", str(root / "bundle"),
                    "--artifacts", artifact])
    with open(artifact) as f:
        return json.load(f), str(root / "bundle" / "ps.json")


def _key_tree(node, names):
    """The artifact's keys: model names as ``<model>``, the histogram's
    bucket keys dropped, leaves as their JSON type."""
    if isinstance(node, dict):
        return {("<model>" if k in names else k):
                ("<buckets>" if k == "buckets" else _key_tree(v, names))
                for k, v in node.items()}
    if isinstance(node, bool) or node is None:
        return repr(node)
    if isinstance(node, (int, float)):
        return "number"
    return type(node).__name__


def test_loadtest_demo_writes_the_references_artifact(tmp_path,
                                                      reference_loadtest):
    ref, _ = reference_loadtest
    artifact = str(tmp_path / "loadtest.json")
    result = loadtest.main(["--arch", "dlrm-criteo,dcn-criteo",
                            *LOADTEST_FLAGS, "--device", "cpu",
                            "--deploy-dir", str(tmp_path / "bundle"),
                            "--artifacts", artifact, "--smoke-assert"])
    with open(artifact) as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(result))
    names = set(got["phases"]["steady"]["client"]["models"])
    assert names == {"dlrm-criteo-smoke", "dcn-criteo-smoke"}
    ref_names = set(ref["phases"]["steady"]["client"]["models"])
    assert _key_tree(got, names) == _key_tree(ref, ref_names)
    for phase in ("steady", "overload"):
        client = got["phases"][phase]["client"]
        assert client["scheduled"] == sum(
            m["scheduled"] for m in client["models"].values())
        for m in client["models"].values():
            assert m["lost"] == 0 and m["errors"] == 0
            assert m["delivered"] + m["shed_observed"] == m["scheduled"]


def test_loadtest_refuses_unknown_mix_names(tmp_path, reference_loadtest):
    _, ps = reference_loadtest
    with pytest.raises(ValueError, match="unknown models"):
        loadtest.main(["--config", ps, "--device", "cpu", "--rows", "4",
                       "--mix", "dlrm=1", "--duration", "0.2",
                       "--artifacts", str(tmp_path / "a.json")])


# ---------------------------------------------------------------------------
# launch.serve
# ---------------------------------------------------------------------------

def test_serve_sanitized_on_a_jax_bundle(reference_loadtest):
    _, ps = reference_loadtest
    rep = serve.main(["--config", ps, "--device", "cpu", "--requests", "4",
                      "--batch", "16", "--sanitize"])
    san = rep["sanitizer"]
    assert san["syncs"] == san["groups"] == 4 and san["compiles"] == 0
    (m,) = rep["models"].values()
    assert m["responses"] == 4 and m["latency_ms"]["p50"] > 0
    assert rep["payload_dev"] == {}


def test_serve_int8_payload_passes_the_crosscheck(reference_loadtest):
    _, ps = reference_loadtest
    rep = serve.main(["--config", ps, "--device", "cpu", "--requests", "2",
                      "--batch", "16", "--payload-dtype", "int8"])
    (dev,) = rep["payload_dev"].values()
    assert 0 <= dev <= serve._PAYLOAD_TOL["int8"]


@pytest.mark.parametrize("archs", ["dlrm-criteo,dcn-criteo",
                                   "twotower-criteo"])
def test_serve_demo_mode(tmp_path, archs):
    rep = serve.main(["--arch", archs, "--train-steps", "1", "--requests",
                      "2", "--batch", "16", "--device", "cpu",
                      "--deploy-dir", str(tmp_path)])
    assert sorted(rep["models"]) == sorted(
        a + "-smoke" for a in archs.split(","))
    assert rep["predictions"] == 2 * 16 * len(rep["models"])
    with open(tmp_path / "ps.json") as f:
        fmt = json.load(f).get("format")
    assert (fmt == "repro-ps-ensemble-v1") == ("," in archs)


# ---------------------------------------------------------------------------
# launch.train, the recsys branch
# ---------------------------------------------------------------------------

TRAIN_FLAGS = ["--arch", "dlrm-criteo", "--smoke", "--device", "cpu",
               "--batch", "64", "--lr", "1e-2", "--log-every", "1"]


def test_train_resumes_from_its_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    first = launch_train.main([*TRAIN_FLAGS, "--steps", "4", "--ckpt-dir",
                               ckpt, "--ckpt-interval", "2"])
    out = capsys.readouterr().out
    assert out.startswith('Model "dlrm-criteo-smoke" -> dlrm (6 tables')
    assert "stragglers flagged" in out
    assert ck.latest_step(ckpt) == 3
    second = launch_train.main([*TRAIN_FLAGS, "--steps", "6", "--ckpt-dir",
                                ckpt, "--ckpt-interval", "2"])
    assert [h["step"] for h in first] == [0, 1, 2, 3]
    assert [h["step"] for h in second] == [4, 5]
    losses = [h["loss"] for h in first + second]
    assert np.isfinite(losses).all()
    # the same steps uninterrupted, through Model.fit
    m = _recipe(registry, "dlrm-criteo").build_model(
        smoke=True, solver=api.Solver(batch_size=64, lr=1e-2))
    m.compile(device="cpu")
    want = [h["loss"] for h in m.fit(steps=6)]
    np.testing.assert_allclose(losses, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    # the launcher's checkpoint loads in the reference's checkpoint module
    assert jck.latest_step(ckpt) == 5
    flat, manifest = jck.load(ckpt, 5)
    port_flat, _ = ck.load(ckpt, 5)
    assert sorted(flat) == sorted(port_flat)
    assert any(k.startswith("params/embedding/") for k in flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, port_flat[k], err_msg=k)


@pytest.mark.parametrize("flags", [["--mode", "manual"], ["--mesh", "2x1"],
                                   ["--comm", "all_to_all"],
                                   ["--grad-ar-dtype", "bf16"]],
                         ids=["manual", "mesh", "comm", "grad_ar_bf16"])
def test_train_recsys_left_out_flags_raise(flags):
    """The mesh flags, once refused: on one process ``--mode manual`` (its
    f32 all-reduce over one rank), ``--comm all_to_all`` and
    ``--grad-ar-dtype bf16`` (a manual-mode knob) train as ``Model.fit``
    does, as the reference's (1, 1) mesh trains; ``--mesh 2x1`` asks for
    two ranks and raises the reference's ``GraphError``, naming the fix."""
    if flags[0] == "--mesh":
        with pytest.raises(japi.GraphError, match="2 devices"):
            japi.Solver(batch_size=64, mesh_shape=(2, 1))
        with pytest.raises(api.GraphError,
                           match="torchrun --nproc-per-node 2"):
            launch_train.main([*TRAIN_FLAGS, *flags])
        return
    hist = launch_train.main([*TRAIN_FLAGS, "--steps", "3", *flags])
    m = _recipe(registry, "dlrm-criteo").build_model(
        smoke=True, solver=api.Solver(batch_size=64, lr=1e-2))
    m.compile(device="cpu")
    want = [h["loss"] for h in m.fit(steps=3)]
    np.testing.assert_allclose([h["loss"] for h in hist], want,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
