"""Config module for ``--arch seamless-m4t-large-v2`` (see the registry for the
source), the port's ``repro/configs/seamless_m4t_large_v2.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "seamless-m4t-large-v2"
CONFIG = LM_ARCHS[ARCH_ID]
