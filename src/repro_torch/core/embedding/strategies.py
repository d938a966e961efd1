"""The paper's three embedding placement / communication strategies
(counterpart of ``repro/core/embedding/strategies.py``).

The reference runs these inside ``shard_map`` over the full mesh; here
every rank runs them on its own block, and the reference's named-axis
collectives are ``torch.distributed`` collectives over the mesh's
sub-groups (``launch.mesh.axis_group``). The batch is split over the DP
axes (``"data"``) and replicated over ``"model"``; embedding shards use
**all** mesh axes (or ``"model"`` alone, ``shard_axes="model"``).

Conventions:
  - ``rows``: mega-table row ids ``[B_dp, T, H]`` int32, ``-1`` = padding.
  - distributed shards are **mod-striped** (``owner = row % N``) for the
    all-to-all path and **block-striped** for the allgather +
    reduce-scatter path.
  - every collective is a ``torch.autograd.Function`` whose backward is
    its adjoint (all-to-all is self-adjoint, all-gather <->
    reduce-scatter, the all-reduce of shard parts <-> the copy of a
    replicated value into shard work), so table gradients flow back
    through the same communication pattern in reverse.

The shard-local work goes through the port's kernels when the caller
passes them: ``pool_fn`` pools (``kernels.ops.kernel_pool``: K1 forward,
K3 backward) and ``gather_fn`` reads the all-to-all owner's rows
(``kernels.ops.row_gather``: K5 forward, K3 backward); the plain versions
by default.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.embedding.common import (
    masked_range_lookup, pooled_local_lookup,
)
from repro_torch.launch import mesh as meshlib


# ---------------------------------------------------------------------------
# Collectives along dim 0 (tiled), each with its adjoint
# ---------------------------------------------------------------------------

#: the one-tensor all-gather (``all_gather_into_tensor`` before its rename)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, x.contiguous(), group=group)
    return out


def _scatter_raw(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce-scatter of {x.shape[0]} rows over {n} "
                         "ranks")
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def _a2a_raw(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x.contiguous())
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    """``jax.lax.all_gather(tiled=True)`` on dim 0; backward: the
    reduce-scatter (sum) of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_raw(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    """``jax.lax.psum_scatter(tiled=True)`` on dim 0; backward: the
    all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    """``jax.lax.all_to_all`` with equal splits of dim 0; its own
    adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a_raw(g, ctx.group), None


def _sum_raw(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    """``jax.lax.psum`` of parts that each rank of ``group`` computed from
    its own shard, into a value the ranks then hold alike; backward: the
    identity. Every rank of the group back-propagates the same loss from
    the sum, so each already holds the whole cotangent of its own part (a
    second sum would scale it by the group's size)."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """The identity on a value the ranks of ``group`` hold alike, where it
    enters work on each rank's own shard; backward: the sum over the group
    of the ranks' cotangents, each the part its own shard saw (the
    adjoint of :class:`_AllReduce`'s pairing)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_raw(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``group`` of their ``x``; the gradient of
    each rank's ``x`` is the cotangent of the sum, unscaled."""
    if x.requires_grad:
        return _AllReduce.apply(x, group)
    return _sum_raw(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (held alike by the ranks of ``group``) as the input of work on
    each rank's own shard: the gradient that reaches ``x`` is the sum over
    the group of what each rank's shard gives it."""
    if x.requires_grad:
        return _CopyToGroup.apply(x, group)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Rank blocks concatenated along dim 0, in group rank order."""
    if x.requires_grad:
        return _AllGather.apply(x, group)
    return _gather_raw(x, group)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's block of dim 0 of it."""
    if x.requires_grad:
        return _ReduceScatter.apply(x, group)
    return _scatter_raw(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of dim 0 to rank ``j``; block ``j`` of the result came
    from rank ``j``."""
    if x.requires_grad:
        return _AllToAll.apply(x, group)
    return _a2a_raw(x, group)


def take_rows(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Plain row read: ``slots [N]`` (-1 = hole) -> ``[N, D]``, a zero row
    for each hole (``jnp.take`` then the mask)."""
    valid = slots >= 0
    rows = table[torch.where(valid, slots, torch.zeros_like(slots)).long()]
    return torch.where(valid[:, None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


# ---------------------------------------------------------------------------
# Distributed slot embedding — all-gather + reduce-scatter path
# ---------------------------------------------------------------------------

def distributed_ag_rs(local_table: torch.Tensor, rows: torch.Tensor, *,
                      mesh, dp_axes: Tuple[str, ...],
                      all_axes: Tuple[str, ...], model_axis: str,
                      shard_rows: int, compute_dtype=None,
                      pool_fn: Optional[Callable] = None) -> torch.Tensor:
    """Block-striped MP lookup.

    1. all-gather ids over ``dp_axes`` (ids are tiny: int32); skipped when
       the shard axes exclude DP (``shard_axes="model"``): each DP row then
       resolves only its own batch shard,
    2. every rank resolves the (gathered) batch against its row range,
    3. reduce-scatter the partial pooled tensor over the shard axes,
    4. all-gather over the model axis to restore the DP batch block.
    """
    rows_all = all_gather(rows, meshlib.axis_group(mesh, dp_axes)) \
        if dp_axes else rows
    v0 = meshlib.axis_index(mesh, all_axes) * shard_rows
    partial = masked_range_lookup(local_table, rows_all, v0,
                                  compute_dtype=compute_dtype,
                                  pool_fn=pool_fn)
    summed = reduce_scatter(partial, meshlib.axis_group(mesh, all_axes))
    if model_axis in all_axes:
        summed = all_gather(summed, meshlib.axis_group(mesh, (model_axis,)))
    return summed


# ---------------------------------------------------------------------------
# Distributed slot embedding — bucketed all-to-all path (HugeCTR-faithful)
# ---------------------------------------------------------------------------

def _bucket_by_owner(flat_rows: torch.Tensor, n_shards: int, capacity: int):
    """Assign each id a slot in a ``[n_shards, capacity]`` send buffer.

    Returns ``(send_buf, slot_of, valid)`` where ``send_buf`` holds *local*
    row ids (``row // n_shards``) with ``-1`` padding, ``slot_of[i]`` is the
    flat slot each input id landed in (or ``n_shards*capacity`` if dropped),
    and ``valid`` marks ids that were neither padding nor overflow. The
    stable sort by owner keeps the reference's order, so an overflowing
    bucket drops the same ids.
    """
    dev = flat_rows.device
    m = flat_rows.shape[0]
    flat = flat_rows.long()
    owner = torch.where(flat >= 0, flat % n_shards, n_shards)
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order]
    start = torch.searchsorted(sorted_owner,
                               torch.arange(n_shards + 1, device=dev))
    pos_sorted = torch.arange(m, device=dev) - start[sorted_owner]
    in_cap = (pos_sorted < capacity) & (sorted_owner < n_shards)
    full = n_shards * capacity
    slot_sorted = torch.where(in_cap, sorted_owner * capacity + pos_sorted,
                              full)
    slot_of = torch.empty(m, dtype=torch.long, device=dev)
    slot_of[order] = slot_sorted
    local_rows = torch.where(flat >= 0, torch.div(flat, n_shards,
                                                  rounding_mode="floor"), -1)
    # one spare slot takes every dropped id (the reference's mode="drop")
    send_buf = torch.full((full + 1,), -1, dtype=torch.long, device=dev)
    send_buf[slot_of] = local_rows
    valid = (flat >= 0) & (slot_of < full)
    return (send_buf[:full].to(torch.int32).view(n_shards, capacity),
            slot_of.to(torch.int32), valid)


def a2a_capacity(m: int, n_shards: int, capacity_factor: float) -> int:
    """Send-buffer slots a shard for ``m`` ids (the reference's formula)."""
    return max(1, int((m + n_shards - 1) // n_shards * capacity_factor))


def distributed_a2a(local_table: torch.Tensor, rows: torch.Tensor, *,
                    mesh, all_axes: Tuple[str, ...], n_shards: int,
                    capacity_factor: float = 2.0, compute_dtype=None,
                    gather_fn: Optional[Callable] = None) -> torch.Tensor:
    """Mod-striped MP lookup with bucketed all-to-all exchange.

    The faithful port of HugeCTR's distributed-slot pattern: ids are routed
    to their owner shard, the owner gathers vectors, and a second all-to-all
    returns them. Static shapes come from a capacity factor (overflow ids
    fall back to zero vectors, the same trade as MoE token dropping).
    """
    b, t, h = rows.shape
    capacity = a2a_capacity(b * t * h, n_shards, capacity_factor)
    send_buf, slot_of, valid = _bucket_by_owner(rows.reshape(-1), n_shards,
                                                capacity)
    group = meshlib.axis_group(mesh, all_axes)
    # requests travel to owners ...
    recv = all_to_all(send_buf.reshape(-1), group)
    resp = (gather_fn or take_rows)(local_table, recv)     # holes read 0
    if compute_dtype is not None:
        resp = resp.to(compute_dtype)
    # ... vectors travel back to requesters
    resp_back = all_to_all(resp, group)
    # a pad row so dropped / overflow slots read zeros
    resp_flat = torch.cat([resp_back, resp_back.new_zeros(
        (1, resp_back.shape[1]))])
    pick = torch.where(valid, slot_of.long(), n_shards * capacity)
    return resp_flat[pick].view(b, t, h, -1).sum(dim=2)


# ---------------------------------------------------------------------------
# Localized slot embedding
# ---------------------------------------------------------------------------

def local_tables_pool(local_tables: torch.Tensor, ids: torch.Tensor, *,
                      compute_dtype=None,
                      pool_fn: Optional[Callable] = None) -> torch.Tensor:
    """``local_tables [Tl, V, D]``, per-table ids ``[B, Tl, H]`` (-1 pad)
    -> ``[B, Tl, D]``: each table pooled from its own ids, as one pool
    over the ``[Tl * V, D]`` view with table ``t``'s rows at ``t * V``."""
    tl, v, d = local_tables.shape
    offs = (torch.arange(tl, dtype=torch.int32, device=ids.device)
            * v)[None, :, None]
    rows = torch.where(ids >= 0, ids.to(torch.int32) + offs,
                       torch.full_like(ids, -1, dtype=torch.int32))
    pool = pool_fn or pooled_local_lookup
    return pool(local_tables.reshape(tl * v, d), rows,
                compute_dtype=compute_dtype)


def localized(local_tables: torch.Tensor, ids: torch.Tensor, *, mesh,
              dp_axes: Tuple[str, ...], all_axes: Tuple[str, ...],
              model_axis: str, tables_per_shard: int, compute_dtype=None,
              pool_fn: Optional[Callable] = None) -> torch.Tensor:
    """Whole tables per rank; all-to-all exchanges pooled vectors.

    ``local_tables``: ``[T/N, V_max, D]``, this rank's tables (padded).
    ``ids``: per-table ids ``[B_dp, T, H]`` (NOT mega-row ids).

    Per the paper: the multi-hot reduction is entirely local; the only
    communication is one all-to-all of pooled vectors along the batch
    dimension (plus the id all-gather that stands in for HugeCTR's
    table-aware data reader).
    """
    ids_all = all_gather(ids, meshlib.axis_group(mesh, dp_axes)) \
        if dp_axes else ids
    t0 = meshlib.axis_index(mesh, all_axes) * tables_per_shard
    my_ids = ids_all[:, t0:t0 + tables_per_shard]             # [B_g, T/N, H]
    pooled = local_tables_pool(local_tables, my_ids,
                               compute_dtype=compute_dtype,
                               pool_fn=pool_fn)               # [B_g, T/N, D]
    n = meshlib.axis_size(mesh, all_axes)
    bg, tl, d = pooled.shape
    if bg % n:
        raise ValueError(f"batch {bg} does not split over {n} ranks")
    got = all_to_all(pooled, meshlib.axis_group(mesh, all_axes))
    # block j came from rank j: its tables, this rank's batch chunk
    out = got.view(n, bg // n, tl, d).transpose(0, 1).reshape(
        bg // n, n * tl, d)                                   # [B_g/N, T, D]
    if model_axis in all_axes:
        out = all_gather(out, meshlib.axis_group(mesh, (model_axis,)))
    return out
