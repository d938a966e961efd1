"""DLRM-on-Criteo expressed as a graph-API recipe (paper §2).

The bottom MLP over the dense features, the pairwise dot interaction
of its output with the pooled embeddings, and the top MLP.

The port's ``repro/configs/dlrm_criteo.py``: ``build_model`` declares
the graph of the registry config (``api.dlrm_graph``), at the same smoke
sizes and names, so it lowers to the same ``recsys_config_hash``;
a ``mesh`` is carried into the model's ``compile``.
"""

from repro_torch.api import DataReaderParams, Model, Solver, paper_recipe
from repro_torch.configs.registry import RECSYS_ARCHS

ARCH_ID = "dlrm-criteo"
CONFIG = RECSYS_ARCHS[ARCH_ID]


def build_model(*, smoke: bool = False, solver: Solver = None,
                reader: DataReaderParams = None, mesh=None) -> Model:
    return paper_recipe(ARCH_ID, smoke=smoke, solver=solver, reader=reader,
                        mesh=mesh)


#: the graph lowers to the same config (parity-tested)
GRAPH_CONFIG = build_model().to_recsys_config()
