"""DeepFM-on-Criteo expressed as a graph-API recipe (paper §2).

TWO embedding branches: the deep dim-16 tables and their dim-1 wide
twins. The ``fm`` layer carries the first-order (wide + dense linear)
and second-order (pairwise hadamard) terms; the sigmoid terminal sums
the FM and deep-tower logits.

The port's ``repro/configs/deepfm_criteo.py``: ``build_model`` declares
the graph of the registry config (``api.deepfm_graph``), at the same smoke
sizes and names, so it lowers to the same ``recsys_config_hash``;
a ``mesh`` is carried into the model's ``compile``.
"""

from repro_torch.api import DataReaderParams, Model, Solver, paper_recipe
from repro_torch.configs.registry import RECSYS_ARCHS

ARCH_ID = "deepfm-criteo"
CONFIG = RECSYS_ARCHS[ARCH_ID]


def build_model(*, smoke: bool = False, solver: Solver = None,
                reader: DataReaderParams = None, mesh=None) -> Model:
    return paper_recipe(ARCH_ID, smoke=smoke, solver=solver, reader=reader,
                        mesh=mesh)


#: the graph lowers to the same config (parity-tested)
GRAPH_CONFIG = build_model().to_recsys_config()
