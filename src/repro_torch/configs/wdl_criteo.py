"""Wide&Deep-on-Criteo expressed as a graph-API recipe (paper §2).

The recipe the two-slot facade could never express: TWO embedding
branches (deep dim-16 tables + dim-1 wide twins), a deep tower with its
own logit head, a wide linear head over [dense, wide], and a sigmoid
terminal summing both logits.

The port's ``repro/configs/wdl_criteo.py``: ``build_model`` declares
the graph of the registry config (``api.wdl_graph``), at the same smoke
sizes and names, so it lowers to the same ``recsys_config_hash``;
a ``mesh`` is carried into the model's ``compile``.
"""

from repro_torch.api import DataReaderParams, Model, Solver, paper_recipe
from repro_torch.configs.registry import RECSYS_ARCHS

ARCH_ID = "wdl-criteo"
CONFIG = RECSYS_ARCHS[ARCH_ID]


def build_model(*, smoke: bool = False, solver: Solver = None,
                reader: DataReaderParams = None, mesh=None) -> Model:
    return paper_recipe(ARCH_ID, smoke=smoke, solver=solver, reader=reader,
                        mesh=mesh)


#: the graph lowers to the same config (parity-tested)
GRAPH_CONFIG = build_model().to_recsys_config()
