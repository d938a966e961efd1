"""Config module for ``--arch recurrentgemma-9b`` (see the registry for the
source), the port's ``repro/configs/recurrentgemma_9b.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "recurrentgemma-9b"
CONFIG = LM_ARCHS[ARCH_ID]
