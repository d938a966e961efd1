"""Entry points over the kernels (counterparts of ``repro/kernels/ops.py``):
the serving reads ``grouped_pooled_lookup`` (every table of a batch in one
launch), ``pooled_cache_lookup``, ``cache_gather`` and its striped twin
``sharded_cache_gather`` (one device, or the mesh half across a cache
mesh's devices: ``mesh_pooled_read``, one owner-mapped launch an entry
for every table of a read), the differentiable ``fused_embedding_lookup`` /
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

import itertools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import _build, hps_gather
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


def _slots_on(slots: Sequence[torch.Tensor], dev: torch.device) -> list:
    """The batch's slot blocks on ``dev`` in one copy (several blocks go
    as one concatenation and come back as views)."""
    if len(slots) == 1:
        return [slots[0].to(dev)]
    flat = torch.cat([s.reshape(-1) for s in slots]).to(dev)
    return [part.view(s.shape) for part, s in zip(
        flat.split([s.numel() for s in slots]), slots)]


def mesh_pooled_read(payloads: Sequence[tuple],
                     slots: Sequence[Union[np.ndarray, torch.Tensor]], *,
                     plain: bool = False,
                     local: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """The mesh half of ``hps_gather.sharded_gather_rows`` /
    ``sharded_dequant_gather_rows`` for every table of a read: ``payloads``
    one ``(blocks, scale blocks or None)`` a table, the per-entry ``[k,
    Cl_t, D]`` blocks of :func:`place_stripes` (one type and width, all
    scaled or none); GLOBAL ``slots [B, H_t]`` (-1 = hole) -> ``[B, T, D]``
    f32 on the first entry's device, ``[:, t]`` table ``t``'s sum over H.

    Each entry makes one owner-mapped read (``hps_gather.owned_read``: K5,
    K6 with scales) of all the tables. Every entry but the first places the
    rows of its stripes in a rows buffer on the first entry's device (the
    output itself where every H is 1); an entry on another device (``local``
    false; by default, whether its blocks lie elsewhere) does so in a zeroed
    buffer of its own, from the one copy of the slots that device gets, and
    the buffers are added on the first device in entry order (the
    reference's one ``psum``, exact: a row has one owner). Then the first
    entry sums each output row's slots in order of h, its own rows from its
    blocks: the one-device read's sums, bit for bit. ``plain`` runs the
    plain version."""
    blocks0 = payloads[0][0]
    out_dev = blocks0[0].device
    stripes = sum(blk.shape[0] for blk in blocks0)
    slots = [slot_tensor(s, out_dev) for s in slots]
    read = hps_gather.owned_read_plain if plain else hps_gather.owned_read
    if local is None:
        local = [blk.device == out_dev for blk in blocks0]
    firsts = list(itertools.accumulate((blk.shape[0] for blk in blocks0),
                                       initial=0))
    b, d = slots[0].shape[0], blocks0[0].shape[-1]
    hots = [s.shape[1] for s in slots]
    out = torch.empty((b, len(payloads), d), dtype=torch.float32,
                      device=out_dev)
    rows = out if all(h == 1 for h in hots) else torch.empty(
        (b, sum(hots), d), dtype=torch.float32, device=out_dev)

    def entry(j, sl, dest, pooled=None):
        return read([p[j] for p, _ in payloads],
                    None if payloads[0][1] is None
                    else [sc[j] for _, sc in payloads],
                    sl, stripes, firsts[j], dest, pooled)

    foreign = [j for j in range(1, len(blocks0)) if not local[j]]
    if foreign:
        rows.zero_()
    moved, parts = {}, []
    for j in foreign:           # first, so they run beside this device's
        dev = blocks0[j].device
        if dev not in moved:
            moved[dev] = _slots_on(slots, dev)
        parts.append(entry(j, moved[dev], torch.zeros(
            rows.shape, dtype=rows.dtype, device=dev)))
    for part in parts:
        rows.add_(part.to(out_dev))
    for j in range(1, len(blocks0)):
        if local[j]:
            entry(j, slots, rows)
    return entry(0, slots, rows, out)


def sharded_cache_gather(stripes, slots: Union[np.ndarray, torch.Tensor],
                         *, scales=None, mesh: Optional[Sequence] = None
                         ) -> torch.Tensor:
    """GLOBAL ``slots [n]`` (-1 = hole) of a striped payload -> ``[n, D]``
    f32, K5 (or K6 with ``scales``).

    Without ``mesh``, ``stripes [N, Cl, D]`` (and ``scales [N, Cl]``) lie
    on one device and are read through their flat view with the slots
    remapped, row for row the reference's host-shard read. With ``mesh``
    (the cache mesh's devices, more than one entry), ``stripes`` and
    ``scales`` are the per-device blocks of :func:`place_stripes`, read by
    :func:`mesh_pooled_read` at one slot a row: one owner-mapped launch an
    entry, the rows summed once on the first device."""
    if mesh is not None and len(mesh) > 1:
        return mesh_pooled_read(((stripes, scales),),
                                (slot_tensor(slots, stripes[0].device)
                                 .reshape(-1, 1),))[:, 0]
    flat, flat_scales = striped_view((stripes, scales))
    idx = slot_tensor(flatten_striped_slots(stripes, slots), stripes.device)
    return cache_gather(flat, idx, scales=flat_scales)


def sharded_pooled_lookup(stripes, slots: torch.Tensor, *, scales=None,
                          mesh: Optional[Sequence] = None) -> torch.Tensor:
    """Pooled serving read off the striped payload, GLOBAL ``slots [B,
    H]`` (-1 = hole) -> sum-pooled ``[B, D]`` f32: on a cache ``mesh``,
    :func:`mesh_pooled_read` of the one table (the reference's
    ``sharded_pooled_lookup``: its rows summed over H; here each entry sums
    its own, then the entries' sums meet); on one device,
    :func:`pooled_cache_lookup` of the flat view."""
    if mesh is not None and len(mesh) > 1:
        return mesh_pooled_read(((stripes, scales),), (slots,))[:, 0]
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
