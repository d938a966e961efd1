"""PyTorch + CUDA port of the HugeCTR reproduction (``repro``).

The package mirrors ``repro``'s layout (``configs/``, ``core/hps/``,
``kernels/``, ``models/recsys/``, ``serve/``, ``launch/``) so each module
has its counterpart by path. It imports ``torch`` and numpy only: the JAX
package is the reference the tests hold this one against, never a
dependency.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`); a CUDA request without a card raises.
Every Pallas kernel on the served path has a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`repro_torch.kernels._build`).
"""
