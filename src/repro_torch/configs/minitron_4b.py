"""Config module for ``--arch minitron-4b`` (see the registry for the
source), the port's ``repro/configs/minitron_4b.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "minitron-4b"
CONFIG = LM_ARCHS[ARCH_ID]
