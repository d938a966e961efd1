"""K7: the flash-attention forward (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py::flash_fwd``, in its
flat layout: ``q [BH, S, D]``, ``k/v [BKV, S, D]`` -> (``o [BH, S, D]``,
``lse [BH, S]`` f32). On CUDA tensors the wrapper launches the
hand-written kernel (bf16 on the tensor cores, f32 with FMAs); on CPU
tensors it runs the plain version, ``ref.flash_attention_ref``. There is
no fallback between the two: a CUDA launch that fails raises. Unlike the TPU kernel, any ``S`` works
(the ragged tail is masked in the kernel).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

NAME = "flash_fwd"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 96, 128, 256)


def _check_shapes(q, k, v, window) -> None:
    _build.require(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
                   f"q, k, v must be 3-D, got {tuple(q.shape)}, "
                   f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    _build.require(k.shape == v.shape and k.shape[1:] == (s, d),
                   f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                   f"[BKV, {s}, {d}]")
    _build.require(k.shape[0] > 0 and bh % k.shape[0] == 0,
                   f"BH {bh} is not a multiple of BKV {k.shape[0]}")
    _build.require(window is None or window > 0,
                   f"window must be positive, got {window}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q [BH, S, D]`` over ``k/v [BKV, S, D]`` (query head
    ``n`` reads KV head ``n // (BH / BKV)``), causal and/or within a
    ``window`` of keys ``j > i - window`` -> (``o`` in ``q``'s type,
    ``lse`` f32). f32 or bf16; D in :data:`HEAD_DIMS` on CUDA."""
    _check_shapes(q, k, v, window)
    if _build.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda(name, t, DTYPES, 3)
        _build.require(t.dtype == q.dtype,
                       f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        _build.require(t.device == q.device,
                       f"{name} on {t.device}, q on {q.device}")
        _build.require(t.data_ptr() % 16 == 0,
                       f"{name} is not 16-byte aligned")
    bh, s, d = q.shape
    _build.require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    _build.launch(NAME, "repro_flash_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  _build.DTYPE_CODES[q.dtype], bh, k.shape[0], s, d,
                  int(causal), 0 if window is None else int(window))
    return o, lse
