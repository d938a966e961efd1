"""Config module for ``--arch olmo-1b`` (see the registry for the
source), the port's ``repro/configs/olmo_1b.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "olmo-1b"
CONFIG = LM_ARCHS[ARCH_ID]
