"""NeuMF-style CTR model — THREE embedding groups, three dims.

The architecture the N-group lowering unlocks: a deep (MLP) branch over
13 dim-64 tables, a GMF-style multiplicative interaction driven by a
separate group of 9 dim-16 tables, and a context group of 4 dim-8 tables
feeding the head directly (at ``smoke``: 6 x 16, 4 x 8 and 2 x 4). No canonical recipe matches — ``to_recsys_config()``
lowers it to ``model="graph"`` with one ``EmbeddingCollection`` (and,
at deploy time, one HPS table set) per group; the cat input carries the
groups' columns back-to-back in declaration order.

A copy of ``repro/configs/neumf_criteo.py`` on the port's graph API
(``build_model`` declares the same graph, so it lowers to the same
``recsys_config_hash``).
"""
from repro_torch.api import (
    DataReaderParams, DenseLayer, Input, Model, SparseEmbedding, Solver,
)
from repro_torch.configs.registry import CRITEO_VOCAB_SIZES

ARCH_ID = "neumf-criteo"


def build_model(*, smoke: bool = False, solver: Solver = None,
                reader: DataReaderParams = None, mesh=None) -> Model:
    if smoke:
        deep_sizes = [min(v, 1000) for v in CRITEO_VOCAB_SIZES[:6]]
        gmf_sizes = [min(v, 500) for v in CRITEO_VOCAB_SIZES[6:10]]
        ctx_sizes = [24, 16]
        d_deep, d_gmf, d_ctx = 16, 8, 4
        tower, head = (32, 16), (16,)
    else:
        deep_sizes = list(CRITEO_VOCAB_SIZES[:13])
        gmf_sizes = list(CRITEO_VOCAB_SIZES[13:22])
        ctx_sizes = list(CRITEO_VOCAB_SIZES[22:])
        d_deep, d_gmf, d_ctx = 64, 16, 8
        tower, head = (256, 64), (64,)
    name = ARCH_ID + ("-smoke" if smoke else "")
    m = Model(solver or Solver(),
              reader or DataReaderParams(num_dense_features=13),
              name=name, mesh=mesh)
    m.add(Input(dense_dim=13))
    # first group is the primary collection; each further group gets its
    # own collection, param key and cat column span
    m.add(SparseEmbedding(
        vocab_sizes=deep_sizes, dim=d_deep, top_name="deep",
        table_names=[f"C{i + 1}" for i in range(len(deep_sizes))]))
    m.add(SparseEmbedding(
        vocab_sizes=gmf_sizes, dim=d_gmf, top_name="gmf"))
    m.add(SparseEmbedding(
        vocab_sizes=ctx_sizes, dim=d_ctx, top_name="ctx"))
    # deep (MLP) branch over dense + the deep group's embeddings
    m.add(DenseLayer("mlp", ["dense", "deep"], ["deep_h"], units=tower,
                     final_activation=True))
    # GMF-style branch: project both sides into a shared space, multiply
    m.add(DenseLayer("mlp", ["dense"], ["u"], units=(16,),
                     final_activation=True))
    m.add(DenseLayer("mlp", ["gmf"], ["v"], units=(16,),
                     final_activation=True))
    m.add(DenseLayer("multiply", ["u", "v"], ["gmf_int"]))
    # context group feeds the head through one small projection
    m.add(DenseLayer("mlp", ["ctx"], ["ctx_h"], units=(8,),
                     final_activation=True))
    m.add(DenseLayer("concat", ["deep_h", "gmf_int", "ctx_h"], ["feats"]))
    m.add(DenseLayer("mlp", ["feats"], ["h"], units=head,
                     final_activation=True))
    m.add(DenseLayer("mlp", ["h"], ["logit"], units=(1,)))
    m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    return m
