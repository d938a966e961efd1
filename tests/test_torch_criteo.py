"""The port's Criteo reader against the JAX package's, on the CPU.

A TSV written by the test (``write_synthetic_file``, the same bytes from
either package) gives the same ``batch(step)`` in both packages, across
an epoch wrap and at CRLF line ends; the streaming ``reader`` matches the
seekable one; a graph with ``DataReaderParams(source="criteo")`` takes
its batches from the file, and 2 ``fit`` steps on it from one state give
the same f32 losses (<= 1e-5) in both packages.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses

import numpy as np

from repro_torch import convert
from repro_torch.configs.base import EmbeddingTableConfig, RecsysConfig
from repro_torch.data import criteo
from repro_torch.models.recsys.dense_graph import GraphError
from repro_torch.models.recsys.model import RecsysModel

VOCABS = tuple(7 + 3 * i for i in range(criteo.NUM_CAT))


def _cfgs():
    from repro.configs.base import EmbeddingTableConfig as JTable
    from repro.configs.base import RecsysConfig as JCfg

    def cfg(table_cls, cfg_cls):
        tables = tuple(table_cls(f"C{i + 1}", v, 8)
                       for i, v in enumerate(VOCABS))
        return cfg_cls(name="criteo-test", model="dcn", tables=tables,
                       num_dense_features=criteo.NUM_INT, bottom_mlp=(),
                       top_mlp=(16, 1), embedding_dim=8, dtype="f32")
    return cfg(JTable, JCfg), cfg(EmbeddingTableConfig, RecsysConfig)


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    """A 37-line file written by the port, and the reference's for the
    same seed."""
    from repro.data import criteo as jcriteo
    jcfg, pcfg = _cfgs()
    d = tmp_path_factory.mktemp("criteo")
    path, jpath = str(d / "port.tsv"), str(d / "jax.tsv")
    criteo.write_synthetic_file(path, 37, pcfg, seed=4)
    jcriteo.write_synthetic_file(jpath, 37, jcfg, seed=4)
    return path, jpath


def test_written_files_are_byte_equal(tsv):
    path, jpath = tsv
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("batch", [5, 16, 37, 50])
def test_batches_match_jax_across_the_epoch_wrap(tsv, batch):
    from repro.data import criteo as jcriteo
    jcfg, pcfg = _cfgs()
    p = criteo.CriteoReader(tsv[0], pcfg, batch)
    j = jcriteo.CriteoReader(tsv[0], jcfg, batch)
    assert p.num_lines == j.num_lines == 37
    for step in (0, 1, 7, 3, 0):      # past one epoch, and back: pure
        _assert_batches_equal(p.batch(step), j.batch(step))
    # the streaming reader's batch s is CriteoReader.batch(s)
    stream = criteo.reader(tsv[0], pcfg, batch)
    for step in range(4):
        _assert_batches_equal(next(stream), p.batch(step))


def test_crlf_and_missing_final_newline(tmp_path, tsv):
    from repro.data import criteo as jcriteo
    jcfg, pcfg = _cfgs()
    with open(tsv[0]) as f:
        lines = f.read().splitlines()
    path = str(tmp_path / "crlf.tsv")
    with open(path, "w", newline="") as f:
        f.write("\r\n".join(lines))            # no newline at the end
    p = criteo.CriteoReader(path, pcfg, 8)
    assert p.num_lines == 37
    for step in (0, 4, 5):
        _assert_batches_equal(p.batch(step),
                              jcriteo.CriteoReader(path, jcfg, 8).batch(step))
        _assert_batches_equal(p.batch(step),
                              criteo.CriteoReader(tsv[0], pcfg, 8).batch(step))
    with open(str(tmp_path / "empty.tsv"), "w"):
        pass
    with pytest.raises(ValueError, match="empty"):
        criteo.CriteoReader(str(tmp_path / "empty.tsv"), pcfg, 8)


def _declare(a, path):
    """An MLP over the dense features and the 26 pooled tables through
    package ``a``'s API, on a Criteo reader of ``path``."""
    m = a.Model(a.CreateSolver(batch_size=16, lr=1e-2),
                a.DataReaderParams(source="criteo", path=path,
                                   num_dense_features=criteo.NUM_INT),
                name="criteo-test")
    m.add(a.Input(dense_dim=criteo.NUM_INT))
    m.add(a.SparseEmbedding(vocab_sizes=list(VOCABS), dim=8, top_name="emb",
                            table_names=[f"C{i + 1}"
                                         for i in range(len(VOCABS))]))
    m.add(a.DenseLayer("mlp", ["dense", "emb"], ["logit"], units=(16, 1)))
    m.add(a.DenseLayer("sigmoid", ["logit"], ["prob"]))
    return m


def _graphs(tsv_path):
    """Both packages' graph on the file at f32, on one port init (the JAX
    init of 26 tables takes seconds a table on the CPU) exported into the
    JAX model through the logical layout."""
    import jax
    import jax.numpy as jnp
    import repro.api as japi
    import repro_torch.api as api
    from repro.models.recsys.model import RecsysModel as JModel
    from repro.models.recsys.model import import_logical_params as jimport
    from repro_torch.models.recsys.model import export_logical_params
    from repro_torch.tree import unflatten
    j, p = _declare(japi, tsv_path), _declare(api, tsv_path)
    j.compile()
    p.compile(device="cpu")
    # train the f32 tier
    j.cfg = dataclasses.replace(j.cfg, dtype="f32")
    p.cfg = dataclasses.replace(p.cfg, dtype="f32")
    p._model = RecsysModel(p.cfg, device="cpu", global_batch=16)
    p._params = p._model.init(torch.Generator().manual_seed(1))
    flat = convert.state_to_flat(export_logical_params(p.model, p.params))
    with j.mesh:
        j._model = JModel(j.cfg, j.mesh, global_batch=16)
        j._params = jimport(j._model, jax.tree_util.tree_map(
            jnp.asarray, unflatten(flat)))
    return j, p


def test_fit_on_the_file_matches_jax(tsv):
    j, p = _graphs(tsv[0])
    data = p._reader_data_fn()
    _assert_batches_equal(data(3), j._reader_data_fn()(3))
    jl = [h["loss"] for h in j.fit(steps=2)]
    pl = [h["loss"] for h in p.fit(steps=2)]
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)


def test_criteo_reader_needs_a_path():
    import repro_torch.api as api
    m = _declare(api, None).compile(device="cpu")
    with pytest.raises(GraphError, match="needs a path"):
        m.fit(steps=1)
