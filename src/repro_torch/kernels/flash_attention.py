"""K7 and K8: the flash-attention forward (``csrc/flash_attention.cu``)
and its backward (``csrc/flash_attention_bwd.cu``).

Counterparts of ``repro/kernels/flash_attention.py::flash_fwd`` and
``::flash_bwd``, in their flat layout: ``q [BH, Sq, D]``, ``k/v [BKV, Sk,
D]`` -> (``o [BH, Sq, D]``, ``lse [BH, Sq]`` f32), and with ``o``, ``lse``
and ``do`` -> (``dq``, ``dk``, ``dv``). ``Sk`` is ``Sq`` for
self-attention; cross-attention (``repro/models/lm/transformer.py::
attn_apply`` with ``kv_from``: ``chunked_attention(causal=False)`` over the
encoder's keys) has a key length of its own, and then neither the causal
mask nor a window applies (the reference aligns no positions across two
lengths, so the pair raises). A causal call may take a query offset
``q_pos0``: query row ``i`` sits at position ``q_pos0 + i`` and sees the
keys ``j <= q_pos0 + i``, with ``q_pos0 + Sq <= Sk`` (a shard of
sequence-parallel attention, the reference's ``chunked_attention(q_pos0=
...)`` under ``seqpar_attention``; the Pallas ``flash_fwd`` has no offset).
Keys that no query of the call sees get zero ``dk`` and ``dv``. On CUDA
tensors each wrapper
launches its hand-written kernels (bf16 on the tensor cores: ``wgmma``
fed by TMA at D 64, 128 and 256, ``mma.sync`` at D 16, 32 and 96; f32
with FMAs); on
CPU tensors it runs the plain version,
``ref.flash_attention_ref`` or ``ref.flash_attention_bwd_ref``. There is
no fallback between the two: a CUDA launch that fails raises. Unlike the
TPU kernels, any ``Sq`` and ``Sk`` work (the ragged tails are masked in
the kernels).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (check_mask, flash_attention_bwd_ref,
                                     flash_attention_ref)

NAME = "flash_fwd"
NAME_BWD = "flash_bwd"
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
#: the longest key length of K7's short-key form at D 64 (four 128-key
#: tiles, ``csrc/flash_attention.cu``'s ``kShortKeys``)
SHORT_KEYS = 512
#: the row padding of K8's lse and D operands: one query tile
LSE_TILE = 64
#: the head dim whose bf16 dk/dv kernel splits each GQA group across blocks
SPLIT_HEAD_DIM = 256
#: blocks an SM that the split dk/dv grid aims for (one block fits an SM)
DKV_WAVES = 2
#: keys a block of K8's bf16 D 64 dk/dv kernel, and the most blocks of a
#: cluster (the portable cluster size) that split its items at short keys
DKV_BLOCK_64, MAX_CLUSTER = 128, 8


def dkv_splits(bkv: int, sk: int, group: int, d: int, dtype: torch.dtype,
               sms: int, sq: Optional[int] = None) -> int:
    """How many ways K8's dk/dv grid splits each block's walk: 1, except

    * for bf16 at D 256, where a grid of ``bkv * ceil(sk / 64)`` key tiles
      would leave SMs idle (recurrentgemma: one KV head, 64 tiles for 132
      SMs). There it is the smallest divisor of ``group`` that gives at
      least :data:`DKV_WAVES` blocks an SM (``group`` itself if none
      does), so each split walks ``group / splits`` heads. Each split's
      blocks write f32 partials that a reduce kernel sums in split order.
    * for bf16 at D 64 with at most :data:`SHORT_KEYS` keys (the short
      form: an encoder, a cross-attention over its output), where
      ``bkv * ceil(sk / 128)`` blocks walk every (64-query tile, query
      head) item of their keys (seamless: 64 blocks for 132 SMs). There it
      is the largest power of two up to :data:`MAX_CLUSTER` that keeps the
      grid within one block an SM and gives each split an item
      (``ceil(sq / 64) * group`` of them; ``sq`` defaults to ``sk``): a
      cluster of that many blocks walks contiguous runs of the items, and
      the first adds the others' f32 partials in split order."""
    if dtype != torch.bfloat16:
        return 1
    if d == SPLIT_HEAD_DIM:
        tiles = bkv * -(-sk // LSE_TILE)
        want = -(-DKV_WAVES * sms // tiles)
        return min((x for x in range(1, group + 1)
                    if group % x == 0 and x >= want), default=group)
    if d != 64 or sk > SHORT_KEYS:
        return 1
    items = -(-(sk if sq is None else sq) // LSE_TILE) * group
    most = min(MAX_CLUSTER, sms // (bkv * -(-sk // DKV_BLOCK_64)), items)
    splits = 1
    while 2 * splits <= most:
        splits *= 2
    return splits


def _check_shapes(q, k, v, causal, window, q_pos0) -> None:
    _build.require(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
                   f"q, k, v must be 3-D, got {tuple(q.shape)}, "
                   f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    sk = k.shape[1]
    _build.require(k.shape == v.shape and k.shape[2] == d and sk > 0,
                   f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                   f"[BKV, Sk, {d}] with Sk > 0")
    check_mask(s, sk, causal, window, q_pos0)
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
              causal: bool = True, window: Optional[int] = None,
              q_pos0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q [BH, Sq, D]`` over ``k/v [BKV, Sk, D]`` (query
    head ``n`` reads KV head ``n // (BH / BKV)``), causal (keys ``j <=
    q_pos0 + i``) and/or within a ``window`` of keys ``j > i - window``
    (``ref.check_mask`` says which calls are legal) ->
    (``o`` in ``q``'s type, ``lse [BH, Sq]`` f32). f32 or bf16; D in :data:`HEAD_DIMS` on CUDA. One launch:
    ``wgmma`` fed by TMA copy rings for bf16 at D = 64, 128 and 256 (at 64
    three warpgroups of 64 queries share each 128-key K/V tile, at 256 two
    query heads of a GQA group do), ``mma.sync`` for bf16 at D 16, 32 and
    96, FMAs for f32. At D 64 with at most :data:`SHORT_KEYS` keys (an
    encoder, a cross-attention over its output) a head's K and V stay in
    shared memory while a block walks many query tiles of the head: the
    same tiles in the same order, so the bits do not depend on the
    form."""
    _check_shapes(q, k, v, causal, window, q_pos0)
    if _build.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_pos0=q_pos0)
    _check_cuda(q, k=k, v=v)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    _build.launch(NAME, "repro_flash_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  _build.DTYPE_CODES[q.dtype], bh, k.shape[0], s,
                  k.shape[1], d, int(causal),
                  0 if window is None else int(window), int(q_pos0))
    return o, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_pos0: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_fwd`: ``q, o, do [BH, Sq, D]``, ``k/v
    [BKV, Sk, D]`` and the forward's ``lse [BH, Sq]`` f32 -> (``dq`` in
    ``q``'s type, ``dk``, ``dv`` in ``k``'s), ``dk``/``dv`` summed over each
    GQA group of query heads (0 for keys no query sees, past ``q_pos0 +
    Sq - 1``). Two launches: the dq kernel and the dk/dv
    kernel (on ``wgmma`` with TMA copy rings for bf16 at D = 64, 128 and
    256, ``mma.sync`` for bf16 at D 16, 32 and 96, FMAs for f32). ``D =
    rowsum(do * o)``, which the JAX package computes outside its kernels,
    is written by a small kernel the dq launch runs first (at D 64 in bf16
    by the dq kernel itself). At D 256 in bf16 the dk/dv
    launch splits each GQA group :func:`dkv_splits` ways across blocks;
    with more than one split its blocks write f32 partials into a
    workspace and a reduce kernel in the same launch sums them in split
    order, so two calls give the same bits. At D 64 in bf16 with at most
    :data:`SHORT_KEYS` keys (an encoder, a cross-attention) both kernels
    take a short form: the dq kernel keeps a head's K and V in shared
    memory while a block walks a part of the head's query tiles (its dq
    and ``D`` keep the long form's bits), and the dk/dv launch runs
    clusters of :func:`dkv_splits` blocks, each walking a run of the
    query tiles, the first adding the others' f32 partials in split order
    (the same bits on every call, not the long form's)."""
    _check_shapes(q, k, v, causal, window, q_pos0)
    _build.require(o.shape == q.shape and do.shape == q.shape,
                   f"o {tuple(o.shape)} and do {tuple(do.shape)} must be "
                   f"{tuple(q.shape)}")
    _build.require(lse.shape == q.shape[:2],
                   f"lse {tuple(lse.shape)} must be {tuple(q.shape[:2])}")
    if _build.on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, q_pos0=q_pos0)
    _check_cuda(q, k=k, v=v, o=o, do=do)
    _build.require_cuda("lse", lse, (torch.float32,), 2)
    _build.require(lse.device == q.device,
                   f"lse on {lse.device}, q on {q.device}")
    _build.require(lse.data_ptr() % 16 == 0, "lse is not 16-byte aligned")
    bh, s, d = q.shape
    sk = k.shape[1]
    # lse and D = rowsum(do * o) padded to whole 64-query tiles, so that the
    # kernels copy a tile's rows of them as one aligned block; the dq launch
    # writes D (and 0 in the padding), the dk/dv launch reads it
    ls = -(-s // LSE_TILE) * LSE_TILE
    lse_p = lse if ls == s else torch.nn.functional.pad(lse, (0, ls - s))
    dcap = torch.empty((bh, ls), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bkv = k.shape[0]
    splits = dkv_splits(bkv, sk, bh // bkv, d, q.dtype,
                        torch.cuda.get_device_properties(
                            q.device).multi_processor_count, sq=s)
    ws = (torch.empty((2, splits, bkv, sk, d), dtype=torch.float32,
                      device=q.device) if splits > 1 and d == SPLIT_HEAD_DIM
          else None)
    tail = (_build.DTYPE_CODES[q.dtype], bh, bkv, s, sk, d, ls, int(causal),
            0 if window is None else int(window), int(q_pos0))
    _build.launch(NAME_BWD, "repro_flash_bwd_dq", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  lse_p.data_ptr(), dcap.data_ptr(), dq.data_ptr(), *tail)
    _build.launch(NAME_BWD, "repro_flash_bwd_dkv", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), lse_p.data_ptr(),
                  dcap.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  None if ws is None else ws.data_ptr(), splits, *tail)
    return dq, dk, dv
