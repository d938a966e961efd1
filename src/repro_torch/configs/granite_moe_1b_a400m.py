"""Config module for ``--arch granite-moe-1b-a400m`` (see the registry for the
source), the port's ``repro/configs/granite_moe_1b_a400m.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "granite-moe-1b-a400m"
CONFIG = LM_ARCHS[ARCH_ID]
