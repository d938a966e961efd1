"""The port stands alone: every ``repro_torch`` module imports with
``jax`` and ``repro`` made unimportable, no source of the port or of
``chip_smoke.py`` names either, and the entry points refuse a CUDA device
that is not there instead of falling back to the CPU."""
import pytest

torch = pytest.importorskip("torch")

import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys

import repro_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
#: the one-line ``configs/<lm arch>.py`` modules, as in the reference
LM_MODULES = ("command_r_plus_104b", "granite_moe_1b_a400m",
              "granite_moe_3b_a800m", "minitron_4b", "olmo_1b",
              "phi3_mini_3_8b", "pixtral_12b", "recurrentgemma_9b",
              "seamless_m4t_large_v2", "xlstm_125m")


def _modules():
    mods = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__,
                                      prefix="repro_torch."):
        mods.append(info.name)
    return mods


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("mod", _modules())
def test_module_imports(mod):
    importlib.import_module(mod)


def test_imports_with_jax_and_repro_blocked():
    for mod in ("core.hps.message_bus", "analysis.hotpath",
                "analysis.concurrency", "analysis.lockorder",
                "analysis.__main__", "loadgen.metrics",
                "core.etc.cache", "core.etc.parameter_server",
                "online.trainer", "online.publisher", "online.freshness",
                "launch.online_train", "data.criteo",
                "configs.dlrm_criteo", "configs.dcn_criteo",
                "configs.deepfm_criteo", "configs.wdl_criteo",
                "core.embedding.frequency", "data.pipeline",
                "loadgen.workload", "loadgen.driver", "launch.serve",
                "launch.loadtest", "launch.train", "analysis.deadcode",
                "models.lm.rglru", "examples.quickstart",
                "examples.train_dlrm_e2e", "examples.serve_online_updates",
                "examples.loadtest_ensemble", "examples.novel_archs",
                "examples.etc_terabyte_training",
                "examples.lm_pretrain_smoke", "models.lm.moe",
                "models.lm.xlstm", "launch.mesh",
                "core.embedding.strategies", "examples.mp_train_smoke",
                *(f"configs.{m}" for m in LM_MODULES)):
        assert f"repro_torch.{mod}" in _modules()
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "mods = ['repro_torch'] + [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, prefix='repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.analysis import HotPathMonitor\n"
        "with HotPathMonitor():\n"        # the twin arms without jax
        "    pass\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and "
        "(k.split('.')[0] in ('jax', 'jaxlib', 'repro'))]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(_modules())


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_jax_or_repro(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {n}"


@pytest.mark.parametrize("mod", LM_MODULES)
def test_lm_config_module_matches_the_reference(mod):
    """Each ``configs/<lm arch>.py`` names its arch and holds the
    reference module's ``CONFIG``, field by field."""
    import dataclasses
    mine = importlib.import_module(f"repro_torch.configs.{mod}")
    ref = importlib.import_module(f"repro.configs.{mod}")
    assert mine.ARCH_ID == ref.ARCH_ID
    assert mine.ARCH_ID.replace("-", "_").replace(".", "_") == mod
    assert dataclasses.asdict(mine.CONFIG) == dataclasses.asdict(ref.CONFIG)


def test_resolve_device():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default resolves to it")
    from repro_torch.configs.registry import (
        dlrm_criteo, reduce_recsys_for_smoke)
    from repro_torch.core.hps.hps import HPS
    from repro_torch.core.hps.persistent_db import PersistentDB
    from repro_torch.models.recsys.model import RecsysModel
    cfg = reduce_recsys_for_smoke(dlrm_criteo)
    with pytest.raises(RuntimeError, match="CUDA"):
        RecsysModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        HPS("m", cfg.tables, PersistentDB(str(tmp_path / "pdb")))
    from repro_torch.api import dlrm_graph
    from repro_torch.core.embedding.collection import EmbeddingCollection
    with pytest.raises(RuntimeError, match="CUDA"):
        dlrm_graph(cfg).compile()
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingCollection(())


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or on a machine without a card, the script
    exits non-zero and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    scripts = [str(alone)]
    if not torch.cuda.is_available():
        scripts.append(os.path.join(ROOT, "chip_smoke.py"))
    for script in scripts:
        res = subprocess.run([sys.executable, script],
                             cwd=os.path.dirname(script),
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0, res.stdout
        assert '"ok"' not in res.stdout
