"""Config module for ``--arch xlstm-125m`` (see the registry for the
source), the port's ``repro/configs/xlstm_125m.py``."""
from repro_torch.configs.registry import LM_ARCHS

ARCH_ID = "xlstm-125m"
CONFIG = LM_ARCHS[ARCH_ID]
