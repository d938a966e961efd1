"""Parallel cross+deep hybrid (DCN-v2 style) — a NOVEL graph.

Unlike canonical DCN (cross and deep towers concatenated into one
combine head), the branches here run in PARALLEL with their own logit
heads, plus a low-order linear branch over a ``slice`` of the dense
features; the sigmoid terminal sums all three logits. The structure
misses the canonical DCN shape on purpose, so ``to_recsys_config()``
lowers it to ``model="graph"`` and the compiled program executes it —
the DPIFrame-style "dense net as a schedulable operator graph" shape.

Exercises ``slice`` and multi-logit terminals on top of the classic
``cross``/``mlp`` vocabulary.

A copy of ``repro/configs/crossdeep_criteo.py`` on the port's graph API
(``build_model`` declares the same graph, so it lowers to the same
``recsys_config_hash``).
"""
from repro_torch.api import (
    DataReaderParams, DenseLayer, Input, Model, SparseEmbedding, Solver,
)
from repro_torch.configs.registry import CRITEO_VOCAB_SIZES

ARCH_ID = "crossdeep-criteo"


def build_model(*, smoke: bool = False, solver: Solver = None,
                reader: DataReaderParams = None, mesh=None) -> Model:
    if smoke:
        sizes = [min(v, 1000) for v in CRITEO_VOCAB_SIZES[:6]]
        deep, n_cross = (32, 16), 2
    else:
        sizes = list(CRITEO_VOCAB_SIZES)
        deep, n_cross = (1024, 256), 4
    name = ARCH_ID + ("-smoke" if smoke else "")
    m = Model(solver or Solver(),
              reader or DataReaderParams(num_dense_features=13),
              name=name, mesh=mesh)
    m.add(Input(dense_dim=13))
    m.add(SparseEmbedding(
        vocab_sizes=sizes, dim=16, top_name="emb",
        table_names=[f"C{i + 1}" for i in range(len(sizes))]))
    m.add(DenseLayer("concat", ["dense", "emb"], ["flat"]))
    # parallel branch 1: cross net with its own logit head
    m.add(DenseLayer("cross", ["flat"], ["crossed"],
                     num_layers=n_cross))
    m.add(DenseLayer("mlp", ["crossed"], ["cross_logit"], units=(1,)))
    # parallel branch 2: deep tower with its own logit head
    m.add(DenseLayer("mlp", ["flat"], ["deep_h"], units=deep,
                     final_activation=True))
    m.add(DenseLayer("mlp", ["deep_h"], ["deep_logit"], units=(1,)))
    # parallel branch 3: low-order linear term over the first dense cols
    m.add(DenseLayer("slice", ["dense"], ["dense_lo"], start=0, stop=4))
    m.add(DenseLayer("mlp", ["dense_lo"], ["lin_logit"], units=(1,)))
    m.add(DenseLayer("sigmoid",
                     ["cross_logit", "deep_logit", "lin_logit"],
                     ["prob"]))
    return m
