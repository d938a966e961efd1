"""K7 and K8: the flash-attention forward (``csrc/flash_attention.cu``)
and its backward (``csrc/flash_attention_bwd.cu``).

Counterparts of ``repro/kernels/flash_attention.py::flash_fwd`` and
``::flash_bwd``, in their flat layout: ``q [BH, S, D]``, ``k/v [BKV, S,
D]`` -> (``o [BH, S, D]``, ``lse [BH, S]`` f32), and with ``o``, ``lse``
and ``do`` -> (``dq``, ``dk``, ``dv``). On CUDA tensors each wrapper
launches its hand-written kernels (bf16 on the tensor cores: ``wgmma``
fed by TMA at D 64, 128 and 256, ``mma.sync`` at D 16, 32 and 96; f32
with FMAs); on
CPU tensors it runs the plain version,
``ref.flash_attention_ref`` or ``ref.flash_attention_bwd_ref``. There is
no fallback between the two: a CUDA launch that fails raises. Unlike the
TPU kernels, any ``S`` works (the ragged tail is masked in the kernels).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

NAME = "flash_fwd"
NAME_BWD = "flash_bwd"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
#: the row padding of K8's lse and D operands: one query tile
LSE_TILE = 64
#: the head dim whose bf16 dk/dv kernel splits each GQA group across blocks
SPLIT_HEAD_DIM = 256
#: blocks an SM that the split dk/dv grid aims for (one block fits an SM)
DKV_WAVES = 2


def dkv_splits(bkv: int, s: int, group: int, d: int, dtype: torch.dtype,
               sms: int) -> int:
    """How many ways K8's dk/dv grid splits each GQA group's query heads:
    1, except for bf16 at D 256, where a grid of ``bkv * ceil(s / 64)``
    key tiles would leave SMs idle (recurrentgemma: one KV head, 64 tiles
    for 132 SMs). There it is the smallest divisor of ``group`` that gives
    at least :data:`DKV_WAVES` blocks an SM (``group`` itself if none
    does), so each split walks ``group / splits`` heads. Each split's
    blocks write f32 partials that a reduce kernel sums in split order."""
    if d != SPLIT_HEAD_DIM or dtype != torch.bfloat16:
        return 1
    tiles = bkv * -(-s // LSE_TILE)
    want = -(-DKV_WAVES * sms // tiles)
    return min((x for x in range(1, group + 1)
                if group % x == 0 and x >= want), default=group)


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


def _check_cuda(q: torch.Tensor, **others: torch.Tensor) -> None:
    """The checks every launch makes on its CUDA operands of ``q``'s type,
    shape rank and device."""
    for name, t in (("q", q), *others.items()):
        _build.require_cuda(name, t, DTYPES, 3)
        _build.require(t.dtype == q.dtype,
                       f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        _build.require(t.device == q.device,
                       f"{name} on {t.device}, q on {q.device}")
        _build.require(t.data_ptr() % 16 == 0,
                       f"{name} is not 16-byte aligned")
    d = q.shape[-1]
    _build.require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q [BH, S, D]`` over ``k/v [BKV, S, D]`` (query head
    ``n`` reads KV head ``n // (BH / BKV)``), causal and/or within a
    ``window`` of keys ``j > i - window`` -> (``o`` in ``q``'s type,
    ``lse`` f32). f32 or bf16; D in :data:`HEAD_DIMS` on CUDA. One launch:
    ``wgmma`` fed by TMA copy rings for bf16 at D = 64, 128 and 256 (at 64
    three warpgroups of 64 queries share each 128-key K/V tile, at 256 two
    query heads of a GQA group do), ``mma.sync`` for bf16 at D 16, 32 and
    96, FMAs for f32."""
    _check_shapes(q, k, v, window)
    if _build.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_cuda(q, k=k, v=v)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    _build.launch(NAME, "repro_flash_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  _build.DTYPE_CODES[q.dtype], bh, k.shape[0], s, d,
                  int(causal), 0 if window is None else int(window))
    return o, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_fwd`: ``q, o, do [BH, S, D]``, ``k/v
    [BKV, S, D]`` and the forward's ``lse [BH, S]`` f32 -> (``dq`` in
    ``q``'s type, ``dk``, ``dv`` in ``k``'s), ``dk``/``dv`` summed over each
    GQA group of query heads. Two launches: the dq kernel and the dk/dv
    kernel (on ``wgmma`` with TMA copy rings for bf16 at D = 64, 128 and
    256, ``mma.sync`` for bf16 at D 16, 32 and 96, FMAs for f32). ``D =
    rowsum(do * o)``, which the JAX package computes outside its kernels,
    is written by a small kernel the dq launch runs first (at D 64 in bf16
    by the dq kernel itself). At D 256 in bf16 the dk/dv
    launch splits each GQA group :func:`dkv_splits` ways across blocks;
    with more than one split its blocks write f32 partials into a
    workspace and a reduce kernel in the same launch sums them in split
    order, so two calls give the same bits."""
    _check_shapes(q, k, v, window)
    _build.require(o.shape == q.shape and do.shape == q.shape,
                   f"o {tuple(o.shape)} and do {tuple(do.shape)} must be "
                   f"{tuple(q.shape)}")
    _build.require(lse.shape == q.shape[:2],
                   f"lse {tuple(lse.shape)} must be {tuple(q.shape[:2])}")
    if _build.on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    _check_cuda(q, k=k, v=v, o=o, do=do)
    _build.require_cuda("lse", lse, (torch.float32,), 2)
    _build.require(lse.device == q.device,
                   f"lse on {lse.device}, q on {q.device}")
    _build.require(lse.data_ptr() % 16 == 0, "lse is not 16-byte aligned")
    bh, s, d = q.shape
    # lse and D = rowsum(do * o) padded to whole 64-query tiles, so that the
    # kernels copy a tile's rows of them as one aligned block; the dq launch
    # writes D (and 0 in the padding), the dk/dv launch reads it
    ls = -(-s // LSE_TILE) * LSE_TILE
    lse_p = lse if ls == s else torch.nn.functional.pad(lse, (0, ls - s))
    dcap = torch.empty((bh, ls), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bkv = k.shape[0]
    splits = dkv_splits(bkv, s, bh // bkv, d, q.dtype,
                        torch.cuda.get_device_properties(
                            q.device).multi_processor_count)
    ws = (torch.empty((2, splits, bkv, s, d), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    tail = (_build.DTYPE_CODES[q.dtype], bh, bkv, s, d, ls, int(causal),
            0 if window is None else int(window))
    _build.launch(NAME_BWD, "repro_flash_bwd_dq", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  lse_p.data_ptr(), dcap.data_ptr(), dq.data_ptr(), *tail)
    _build.launch(NAME_BWD, "repro_flash_bwd_dkv", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), lse_p.data_ptr(),
                  dcap.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  None if ws is None else ws.data_ptr(), splits, *tail)
    return dq, dk, dv
