"""Config module for ``--arch command-r-plus-104b`` (see the registry for the
source), the port's ``repro/configs/command_r_plus_104b.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "command-r-plus-104b"
CONFIG = LM_ARCHS[ARCH_ID]
