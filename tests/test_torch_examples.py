"""The torch twins of ``examples/`` run on the CPU at their smallest
settings, each through its ``main`` (``python -m
repro_torch.examples.<name> --device cpu`` in process), and pass the
checks the reference's scripts print: the loss falls, the rebuilt server
agrees with the training forward pass, the online model drifts while its
static co-tenant does not, the injected failure is replayed from a
checkpoint, the ETC learns, the load test delivers in both phases. (The
LM twin on seamless-m4t-large-v2 and pixtral-12b raises the reference's
``KeyError``, held in ``tests/test_torch_encdec.py``.)
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.examples import (
    etc_terabyte_training, lm_pretrain_smoke, loadtest_ensemble,
    novel_archs, quickstart, serve_online_updates, train_dlrm_e2e,
)
from repro_torch.kernels import _build

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU every twin runs the plain versions: no kernel launches."""
    _build.LAUNCHES.reset()
    yield
    assert _build.LAUNCHES.snapshot() == {}


def test_quickstart():
    out = quickstart.main(CPU + ["--steps", "6"])
    assert out["losses"][-1] < out["losses"][0]
    assert out["predictions"] == 256 and 0 < out["l1_hit_rate"] <= 1


def test_train_dlrm_e2e_replays_the_injected_failure():
    out = train_dlrm_e2e.main(CPU + ["--steps", "40", "--batch", "256",
                                     "--vocab-cap", "2000",
                                     "--ckpt-interval", "10"])
    assert out["failures"] == [20]
    steps = [h["step"] for h in out["history"]]
    # the failed step replays from the step-10 checkpoint, then finishes
    assert steps[-1] == 39 and steps.count(11) == 2
    assert out["auc"] > 0.6


def test_serve_online_updates():
    out = serve_online_updates.main(CPU + ["--windows", "1"])
    assert out["drift"]["online"] > 0 and out["drift"]["static"] == 0
    refresh = out["stats"]["online"]["hps"]["refresh"]
    assert refresh["rows_refreshed"] > 0 and refresh["backlog"] == 0
    assert out["stats"]["static"]["hps"]["refresh"]["rows_refreshed"] == 0


def test_loadtest_ensemble():
    out = loadtest_ensemble.main(CPU + ["--train-steps", "1",
                                        "--duration", "1",
                                        "--overload-duration", "0.5"])
    assert set(out["phases"]) == {"steady", "overload"}
    for phase in out["phases"].values():
        assert sum(m["delivered"]
                   for m in phase["client"]["models"].values()) > 0


def test_novel_archs():
    out = novel_archs.main(CPU + ["--steps", "3"])
    assert [o["name"] for o in out] == ["twotower-criteo-smoke",
                                        "crossdeep-criteo-smoke"]
    assert all(np.isfinite(o["losses"]).all() for o in out)


def test_etc_terabyte_training():
    out = etc_terabyte_training.main(CPU + ["--vocab", "20000",
                                            "--steps", "30"])
    assert out["pulls"] > 0 and out["evictions"] > 0
    assert np.mean(out["losses"][-10:]) < np.mean(out["losses"][:10])


@pytest.mark.parametrize("arch,steps", [("olmo-1b", 5),
                                        ("recurrentgemma-9b", 10),
                                        ("granite-moe-1b-a400m", 5),
                                        ("xlstm-125m", 5)])
def test_lm_pretrain_smoke(arch, steps):
    losses = lm_pretrain_smoke.main(CPU + ["--arch", arch,
                                           "--steps", str(steps)])
    assert len(losses) == steps and losses[-1] < losses[0]
