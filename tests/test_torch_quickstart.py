"""The paper's workflow (``examples/quickstart.py``) through the port on the
CPU: declare the DLRM graph, ``fit(20)``, ``deploy``, rebuild the server
from ``ps.json`` alone and serve. Served probabilities match the trained
model's ``predict`` within 2e-2 (the bf16 dense net, the bound the
quickstart holds the JAX package to), through the port's
``build_server_from_config`` and through the JAX package's. ``save``d
models load in the other package and predict the same within 2e-2.
"""
import pytest

torch = pytest.importorskip("torch")

import os

import numpy as np
import jax

from repro import api as japi
from repro.launch.serve import build_server_from_config as jbuild

from repro_torch import api
from repro_torch.data.synthetic import SyntheticCTR
from repro_torch.launch.serve import build_server_from_config

PROB_TOL = 2e-2


def _quickstart(pkg):
    """The graph of ``examples/quickstart.py``, declared in ``pkg``."""
    solver = pkg.CreateSolver(batch_size=256, lr=1e-2)
    reader = pkg.DataReaderParams(source="synthetic", num_dense_features=13)
    m = pkg.Model(solver, reader, name="quickstart-dlrm")
    m.add(pkg.Input(dense_dim=13))
    m.add(pkg.SparseEmbedding(vocab_sizes=[1000, 584, 1000, 306, 24, 634],
                              dim=16, top_name="emb"))
    m.add(pkg.DenseLayer("mlp", ["dense"], ["bot"], units=(32, 16),
                         final_activation=True))
    m.add(pkg.DenseLayer("dot_interaction", ["bot", "emb"], ["inter"]))
    m.add(pkg.DenseLayer("concat", ["bot", "inter"], ["top_in"]))
    m.add(pkg.DenseLayer("mlp", ["top_in"], ["logit"], units=(32, 16, 1)))
    m.add(pkg.DenseLayer("sigmoid", ["logit"], ["prob"]))
    return m


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    m = _quickstart(api).compile(device="cpu")
    hist = m.fit(steps=20)
    root = str(tmp_path_factory.mktemp("bundle"))
    server = m.deploy(root, cache_capacity=512)
    server.close()
    return m, hist, os.path.join(root, "ps.json")


def test_fit_learns(trained):
    m, hist, _ = trained
    assert [h["step"] for h in hist] == list(range(20))
    losses = [h["loss"] for h in hist]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_port_serves_its_bundle(trained):
    m, _, ps = trained
    server, graph = build_server_from_config(ps, device="cpu")
    try:
        assert graph.name == "quickstart-dlrm"
        data = SyntheticCTR(m.cfg, 256)
        warm = data.batch(998)
        server.predict(warm["dense"], warm["cat"])
        req = data.batch(999)
        preds = server.predict(req["dense"], req["cat"])
        np.testing.assert_allclose(preds, m.predict(req), rtol=PROB_TOL,
                                   atol=PROB_TOL)
    finally:
        server.close()


def test_jax_serves_the_port_bundle(trained):
    m, _, ps = trained
    jserver, jm = jbuild(ps)
    assert jm.name == m.name
    req = SyntheticCTR(m.cfg, 256).batch(999)
    preds = jserver.predict(req["dense"], req["cat"])
    assert preds.shape == (256,) and np.isfinite(preds).all()
    np.testing.assert_allclose(preds, m.predict(req), rtol=PROB_TOL,
                               atol=PROB_TOL)


def test_saved_models_load_in_the_other_package(trained, tmp_path):
    m, _, _ = trained
    req = SyntheticCTR(m.cfg, 64).batch(5)
    m.save(str(tmp_path / "port"))
    jm = japi.Model.load(str(tmp_path / "port"))
    np.testing.assert_allclose(jm.predict(req), m.predict(req),
                               rtol=PROB_TOL, atol=PROB_TOL)
    # and back: JAX trains, saves; the port loads, predicts, keeps training
    j = _quickstart(japi)
    j.compile()
    j.fit(steps=3)
    j.save(str(tmp_path / "jax"))
    p = api.Model.load(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(p.predict(req), j.predict(req),
                               rtol=PROB_TOL, atol=PROB_TOL)
    hist = p.fit(steps=2)
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_unported_training_options_raise():
    m = _quickstart(api)
    m.solver.etc = {"cache_rows": 64}
    m.compile(device="cpu")
    with pytest.raises(NotImplementedError, match="ETC"):
        m.fit(steps=1)
    m = _quickstart(api)
    m.solver.mode = "manual"
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        m.compile(device="cpu")
    m = _quickstart(api)
    m.reader.source = "criteo"
    m.compile(device="cpu")
    with pytest.raises(NotImplementedError, match="criteo"):
        m.fit(steps=1)
