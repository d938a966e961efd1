"""Entry points over the kernels (counterparts of ``repro/kernels/ops.py``):
the serving reads ``grouped_pooled_lookup`` (every table of a batch in one
launch), ``pooled_cache_lookup``, ``cache_gather`` and its striped twin
``sharded_cache_gather`` (one device, or the mesh half across a cache
mesh's devices), the differentiable ``fused_embedding_lookup`` /
``kernel_pool``, ``row_gather`` and ``dot_interaction`` that training
runs, and the LM's ``flash_attention``.

Each picks by the tensors' device, through its kernel's wrapper: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors. The JAX
package padded inputs to the Pallas kernels' block shapes; the CUDA
kernels take any shape, so nothing is padded here. The JAX ``custom_vjp``s
become ``torch.autograd.Function``s whose backward is the adjoint kernel
(K3 for the lookup, K4 for the interaction, K8 for flash attention).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dot_interaction import interaction_bwd, interaction_fwd
from repro_torch.kernels.embedding_lookup import (lookup_bwd, lookup_fwd,
                                                  lookup_fwd_grouped)
from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
from repro_torch.kernels.hps_gather import (
    dequant_gather_grouped, dequant_gather_rows, gather_rows)
from repro_torch.kernels.ref import acc_dtype, flash_attention_ref


def grouped_pooled_lookup(payloads: Sequence[tuple],
                          slots: Sequence[torch.Tensor]) -> torch.Tensor:
    """``payloads``: one ``(payload [C_t, D], scales [C_t] or None)``
    snapshot a table, all of one type; ``slots``: one ``[B, H_t]`` int32
    block a table (-1 = hole) -> sum-pooled ``[B, T, D]`` f32. Int8 (scaled)
    payloads go through K6, which dequantizes each row before the sum, the
    others through K1: one launch for all the tables on CUDA."""
    tables = [p for p, _ in payloads]
    scales = [sc for _, sc in payloads]
    if all(sc is None for sc in scales):
        return lookup_fwd_grouped(tables, slots)
    if any(sc is None for sc in scales):
        raise ValueError("payloads with and without scales in one read")
    return dequant_gather_grouped(tables, scales, slots)


def pooled_cache_lookup(payload: torch.Tensor, slots: torch.Tensor,
                        scales: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``payload [C, D]``, ``slots [B, H]`` int32 (-1 = hole) -> sum-pooled
    ``[B, D]`` f32: :func:`grouped_pooled_lookup` of one table."""
    return grouped_pooled_lookup(((payload, scales),), (slots,))[:, 0]


def cache_gather(payload: torch.Tensor, slots: torch.Tensor, *,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``payload [C, D]``, ``slots [N]`` int32 (-1 = hole -> zero row) ->
    ``[N, D]`` f32, through K6 when ``scales`` is given and K5 otherwise."""
    if scales is not None:
        return dequant_gather_rows(payload, scales, slots)
    return gather_rows(payload, slots)


def slot_tensor(slots: Union[np.ndarray, torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """Slots as the int32 tensor the reads take: a tensor passes through,
    a numpy block is copied to ``device``."""
    if isinstance(slots, torch.Tensor):
        return slots
    return torch.from_numpy(np.ascontiguousarray(slots, np.int32)).to(device)


# ---------------------------------------------------------------------------
# The striped L1 payload on one device: stripes [N, Cl, D], slot s at
# [s % N, s // N] (the reference's host-shard branch)
# ---------------------------------------------------------------------------

def flatten_striped_slots(stripes: torch.Tensor,
                          slots: Union[np.ndarray, torch.Tensor]):
    """Remap GLOBAL slot ids onto the row-major flattening of ``stripes``
    (``[N, Cl, D] -> [N * Cl, D]``: slot ``s`` becomes row
    ``(s % N) * Cl + s // N``), keeping -1 holes. Numpy slots are remapped
    on the host, where the serving path builds its slot blocks, so the
    striping adds no device work; tensor slots on their device."""
    n, cl = stripes.shape[0], stripes.shape[1]
    if isinstance(slots, torch.Tensor):
        flat = (slots % n) * cl + torch.div(slots, n, rounding_mode="floor")
        return torch.where(slots >= 0, flat, -1).to(slots.dtype)
    slots = np.asarray(slots)
    return np.where(slots >= 0, (slots % n) * cl + slots // n,
                    -1).astype(slots.dtype)


def striped_view(snapshot: tuple) -> tuple:
    """A striped ``(stripes [N, Cl, D], scales [N, Cl] or None)`` snapshot
    as the flat ``[N * Cl, D]`` rows (and ``[N * Cl]`` scales) the
    one-device kernels read: views, free for the contiguous stripes."""
    stripes, scales = snapshot
    return (stripes.view(-1, stripes.shape[-1]),
            None if scales is None else scales.view(-1))


def place_stripes(stripes: torch.Tensor, scales: Optional[torch.Tensor],
                  mesh: Sequence) -> tuple:
    """Lay ``stripes [N, Cl, D]`` (and ``scales [N, Cl]``) out over the
    cache ``mesh`` (a list of devices, ``launch.mesh.make_cache_mesh``):
    stripe ``i`` on device ``i * size // N``, so device
    ``j`` holds the ``[k, Cl, D]`` block of stripes ``j * k .. j * k + k -
    1`` (``k = N / size``). Returns ``(blocks, scale blocks or None)``."""
    n, size = stripes.shape[0], len(mesh)
    if n % size:
        raise ValueError(f"{n} stripes do not tile a cache mesh of "
                         f"{size} devices")
    k = n // size
    blocks = tuple(stripes[j * k:(j + 1) * k].to(torch.device(dev))
                   .contiguous() for j, dev in enumerate(mesh))
    if scales is None:
        return blocks, None
    return blocks, tuple(scales[j * k:(j + 1) * k].to(torch.device(dev))
                         .contiguous() for j, dev in enumerate(mesh))


def _local_stripe_gather(block: torch.Tensor,
                         scales: Optional[torch.Tensor],
                         slots: torch.Tensor, n_stripes: int,
                         first: int) -> torch.Tensor:
    """Per-device body (``hps_gather._local_stripe_gather``): gather the
    slots whose stripe this device owns. ``block [k, Cl, D]`` holds
    stripes ``first .. first + k - 1``; global slot ``s`` maps to stripe
    ``s % N``, local row ``s // N``. Slots owned elsewhere become -1 holes
    and read zero rows, so the sum of the devices' partials is exact. One
    K5 launch (K6 with ``scales [k, Cl]``) on the block's device."""
    k, cl, d = block.shape
    stripe_of = torch.where(slots >= 0, slots % n_stripes, -1)
    mine = (stripe_of >= first) & (stripe_of < first + k)
    local = (stripe_of - first) * cl + torch.div(slots, n_stripes,
                                                 rounding_mode="floor")
    local = torch.where(mine, local, -1).to(torch.int32)
    flat = block.view(k * cl, d)
    return cache_gather(flat, local, scales=None if scales is None
                        else scales.view(k * cl))


def _mesh_gather(blocks: Sequence[torch.Tensor],
                 scales: Optional[Sequence[torch.Tensor]],
                 slots: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """The mesh half of ``hps_gather.sharded_gather_rows`` /
    ``sharded_dequant_gather_rows``: each device's body over its own
    block, then the ``[n, D]`` partials on the first device, summed once
    (the reference's one ``psum``)."""
    n_stripes = sum(b.shape[0] for b in blocks)
    out_dev = blocks[0].device
    parts, first = [], 0
    for j, block in enumerate(blocks):
        s = slot_tensor(slots, block.device).to(block.device)
        parts.append(_local_stripe_gather(
            block, None if scales is None else scales[j], s, n_stripes,
            first).to(out_dev))
        first += block.shape[0]
    return torch.stack(parts).sum(dim=0)


def sharded_cache_gather(stripes, slots: Union[np.ndarray, torch.Tensor],
                         *, scales=None, mesh: Optional[Sequence] = None
                         ) -> torch.Tensor:
    """GLOBAL ``slots [n]`` (-1 = hole) of a striped payload -> ``[n, D]``
    f32, K5 (or K6 with ``scales``).

    Without ``mesh``, ``stripes [N, Cl, D]`` (and ``scales [N, Cl]``) lie
    on one device and are read through their flat view with the slots
    remapped, row for row the reference's host-shard read. With ``mesh``
    (the cache mesh's devices, more than one entry), ``stripes`` and
    ``scales`` are the per-device blocks of :func:`place_stripes`: each
    device reads its own stripes, the others' slots set to -1, and the
    partial rows are summed once on the first device."""
    if mesh is not None and len(mesh) > 1:
        return _mesh_gather(stripes, scales, slots)
    flat, flat_scales = striped_view((stripes, scales))
    idx = slot_tensor(flatten_striped_slots(stripes, slots), stripes.device)
    return cache_gather(flat, idx, scales=flat_scales)


def sharded_pooled_lookup(stripes, slots: torch.Tensor, *, scales=None,
                          mesh: Optional[Sequence] = None) -> torch.Tensor:
    """Pooled serving read off the striped payload, GLOBAL ``slots [B,
    H]`` (-1 = hole) -> sum-pooled ``[B, D]`` f32: on a cache ``mesh``,
    :func:`sharded_cache_gather`'s rows summed over H (the reference's
    ``sharded_pooled_lookup``); on one device, :func:`pooled_cache_lookup`
    of the flat view."""
    if mesh is not None and len(mesh) > 1:
        b, h = slots.shape
        rows = _mesh_gather(stripes, scales, slots.reshape(-1))
        return rows.view(b, h, -1).sum(dim=1)
    flat, flat_scales = striped_view((stripes, scales))
    return pooled_cache_lookup(flat, flatten_striped_slots(stripes, slots),
                               flat_scales)


# ---------------------------------------------------------------------------
# Training: the pooled lookup (K1 forward, K3 backward)
# ---------------------------------------------------------------------------

class _FusedLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, rows):
        ctx.table_shape = tuple(table.shape)
        ctx.save_for_backward(rows)
        return lookup_fwd(table, rows)

    @staticmethod
    def backward(ctx, dpooled):
        rows, = ctx.saved_tensors
        dpooled = dpooled.to(acc_dtype(dpooled.dtype)).contiguous()
        return lookup_bwd(ctx.table_shape, rows, dpooled), None


class _RowGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, slots):
        ctx.table_shape = tuple(table.shape)
        ctx.save_for_backward(slots)
        return gather_rows(table, slots)

    @staticmethod
    def backward(ctx, drows):
        slots, = ctx.saved_tensors
        drows = drows.to(torch.float32).contiguous()
        return lookup_bwd(ctx.table_shape, slots.view(-1, 1), drows), None


def row_gather(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``table [V, D]`` f32, ``slots [N]`` int32 (-1 = hole) -> ``[N, D]``
    f32 rows through K5, a zero row for each hole; the gradient reaches
    ``table`` as the dense ``[V, D]`` scatter-add of K3 at one id a row
    (the all-to-all owner's gather and its adjoint)."""
    return _RowGather.apply(table, slots.contiguous())


def fused_embedding_lookup(table: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """``table [V, D]``, ``rows [B, H]`` int32 (-1 pad) -> sum-pooled
    ``[B, D]`` f32; the gradient reaches ``table`` as the dense ``[V, D]``
    f32 adjoint."""
    return _FusedLookup.apply(table, rows)


def kernel_pool(mega: torch.Tensor, rows: torch.Tensor, *,
                combiner: str = "sum",
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``rows [B, T, H]`` mega-table row ids (-1 pad) -> ``[B, T, D]``,
    in the reference's cast order: an f32 pool, the mean renorm, then the
    compute dtype."""
    b, t, h = rows.shape
    out = fused_embedding_lookup(mega, rows.reshape(b * t, h))
    out = out.reshape(b, t, -1)
    if combiner == "mean":
        denom = (rows >= 0).sum(-1, keepdim=True).clamp_min(1)
        out = out / denom.to(out.dtype)
    if compute_dtype is not None:
        out = out.to(compute_dtype)
    return out


# ---------------------------------------------------------------------------
# DLRM dot interaction (K2 forward, K4 backward)
# ---------------------------------------------------------------------------

class _DotInteraction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, self_interaction):
        ctx.self_interaction = self_interaction
        ctx.save_for_backward(x)
        # K2 reads f32 (the TPU kernel cast its tile to f32 the same way)
        return interaction_fwd(x.to(acc_dtype(x.dtype)),
                               self_interaction=self_interaction)

    @staticmethod
    def backward(ctx, dtri):
        x, = ctx.saved_tensors
        dtri = dtri.to(acc_dtype(dtri.dtype)).contiguous()
        return interaction_bwd(x, dtri,
                               self_interaction=ctx.self_interaction), None


def dot_interaction(x: torch.Tensor,
                    self_interaction: bool = False) -> torch.Tensor:
    """``x [B, F, D]`` -> pairwise-dot triangle ``[B, P]`` f32 (K2); the
    gradient ``dx`` comes from K4 in ``x``'s type."""
    return _DotInteraction.apply(x, self_interaction)


# ---------------------------------------------------------------------------
# Flash attention (K7 forward, K8 backward)
# ---------------------------------------------------------------------------

def _bhsd(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> [B·H, S, D] (contiguous: at B = 1 the reshape alone
    is a strided view)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _unbhsd(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B·H, S, D] -> [B, S, H, D] (a view)."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """K7 forward, K8 backward. The kernels write into ``torch.empty``
    buffers that autograd cannot see through, so this Function carries the
    gradient: forward saves the flat, contiguous q, k and v (the ``_bhsd``
    copies the kernels read; k and v with their own key length), ``o``
    and K7's ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_pos0):
        qf, kf, vf = _bhsd(q), _bhsd(k), _bhsd(v)
        o, lse = flash_fwd(qf, kf, vf, causal=causal, window=window,
                           q_pos0=q_pos0)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal, ctx.window, ctx.q_pos0 = causal, window, q_pos0
        return _unbhsd(o, q.shape[0])

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        b = do.shape[0]
        dq, dk, dv = flash_bwd(qf, kf, vf, o, lse, _bhsd(do),
                               causal=ctx.causal, window=ctx.window,
                               q_pos0=ctx.q_pos0)
        return (_unbhsd(dq, b), _unbhsd(dk, b), _unbhsd(dv, b), None, None,
                None)


def _use_kernel(*tensors: torch.Tensor) -> bool:
    return not _build.on_cpu(*tensors)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None,
                          q_pos0: int = 0) -> torch.Tensor:
    """The plain version of :func:`flash_attention` on any device, in
    plain torch ops that autograd differentiates."""
    o, _ = flash_attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                               window=window, q_pos0=q_pos0)
    return _unbhsd(o, q.shape[0])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_pos0: int = 0) -> torch.Tensor:
    """``q [B, Sq, Hq, D]``, ``k/v [B, Sk, Hkv, D]`` -> ``[B, Sq, Hq,
    D]``: K7 forward and K8 backward on CUDA tensors, the plain version on
    CPU tensors. ``Sk`` other than ``Sq`` takes neither a ``window`` nor,
    without a query offset ``q_pos0`` (query row ``i`` at position ``q_pos0
    + i``: a shard of sequence-parallel attention), ``causal``
    (``ref.check_mask``)."""
    if _use_kernel(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, q_pos0)
    return flash_attention_plain(q, k, v, causal, window, q_pos0)
