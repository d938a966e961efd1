"""Config module for ``--arch pixtral-12b`` (see the registry for the
source), the port's ``repro/configs/pixtral_12b.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "pixtral-12b"
CONFIG = LM_ARCHS[ARCH_ID]
