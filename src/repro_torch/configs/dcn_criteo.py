"""DCN-on-Criteo expressed as a graph-API recipe (paper §2).

Cross network + deep tower over the shared feature concat, combined by
a 1-unit head — declared with ``model.add(...)`` and lowered onto the
registry config (parity-tested).

The port's ``repro/configs/dcn_criteo.py``: ``build_model`` declares
the graph of the registry config (``api.dcn_graph``), at the same smoke
sizes and names, so it lowers to the same ``recsys_config_hash``;
a ``mesh`` is carried into the model's ``compile``.
"""

from repro_torch.api import DataReaderParams, Model, Solver, paper_recipe
from repro_torch.configs.registry import RECSYS_ARCHS

ARCH_ID = "dcn-criteo"
CONFIG = RECSYS_ARCHS[ARCH_ID]


def build_model(*, smoke: bool = False, solver: Solver = None,
                reader: DataReaderParams = None, mesh=None) -> Model:
    return paper_recipe(ARCH_ID, smoke=smoke, solver=solver, reader=reader,
                        mesh=mesh)


#: the graph lowers to the same config (parity-tested)
GRAPH_CONFIG = build_model().to_recsys_config()
