"""Config module for ``--arch phi3-mini-3.8b`` (see the registry for the
source), the port's ``repro/configs/phi3_mini_3_8b.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "phi3-mini-3.8b"
CONFIG = LM_ARCHS[ARCH_ID]
