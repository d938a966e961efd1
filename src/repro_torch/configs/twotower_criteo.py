"""Two-tower residual CTR model — a NOVEL graph, no recipe code.

The scenario the generic dense-graph compiler unlocks: a user tower
(dense features) and an item tower (pooled embeddings) meet in an
elementwise interaction; the dot-product logit and a residual MLP head
are summed by the sigmoid terminal. None of this matches a canonical
recipe — ``to_recsys_config()`` lowers it to ``model="graph"`` with the
DAG embedded, and training, JSON round-trip, deployment, config-driven
serving and numpy export all run through the same compiled program with
zero per-architecture code.

Exercises the extended layer vocabulary: ``multiply``, ``reduce_sum``,
multi-input ``concat``, ``add`` (residual), ``relu``.

A copy of ``repro/configs/twotower_criteo.py`` on the port's graph API
(``build_model`` declares the same graph, so it lowers to the same
``recsys_config_hash``).
"""
from repro_torch.api import (
    DataReaderParams, DenseLayer, Input, Model, SparseEmbedding, Solver,
)
from repro_torch.configs.registry import CRITEO_VOCAB_SIZES

ARCH_ID = "twotower-criteo"


def build_model(*, smoke: bool = False, solver: Solver = None,
                reader: DataReaderParams = None, mesh=None) -> Model:
    if smoke:
        sizes = [min(v, 1000) for v in CRITEO_VOCAB_SIZES[:6]]
        dim, tower, head = 16, (32, 16), (16,)
    else:
        sizes = list(CRITEO_VOCAB_SIZES)
        dim, tower, head = 64, (256, 64), (64,)
    name = ARCH_ID + ("-smoke" if smoke else "")
    m = Model(solver or Solver(),
              reader or DataReaderParams(num_dense_features=13),
              name=name, mesh=mesh)
    m.add(Input(dense_dim=13))
    m.add(SparseEmbedding(
        vocab_sizes=sizes, dim=dim, top_name="emb",
        table_names=[f"C{i + 1}" for i in range(len(sizes))]))
    # the two towers project into a shared space
    m.add(DenseLayer("mlp", ["dense"], ["user"], units=tower,
                     final_activation=True))
    m.add(DenseLayer("mlp", ["emb"], ["item"], units=tower,
                     final_activation=True))
    # tower match: elementwise product, reduced to a dot-product logit
    m.add(DenseLayer("multiply", ["user", "item"], ["inter"]))
    m.add(DenseLayer("reduce_sum", ["inter"], ["dot"]))
    # residual head over [user, item, interaction]
    m.add(DenseLayer("concat", ["user", "item", "inter"], ["feats"]))
    m.add(DenseLayer("mlp", ["feats"], ["h"], units=head,
                     final_activation=True))
    m.add(DenseLayer("mlp", ["h"], ["h2"], units=head))
    m.add(DenseLayer("add", ["h", "h2"], ["res"]))
    m.add(DenseLayer("relu", ["res"], ["res_act"]))
    m.add(DenseLayer("mlp", ["res_act"], ["head"], units=(1,)))
    m.add(DenseLayer("sigmoid", ["dot", "head"], ["prob"]))
    return m
