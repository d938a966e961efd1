"""Config module for ``--arch granite-moe-3b-a800m`` (see the registry for the
source), the port's ``repro/configs/granite_moe_3b_a800m.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "granite-moe-3b-a800m"
CONFIG = LM_ARCHS[ARCH_ID]
