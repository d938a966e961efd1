"""Shared machinery for the embedding engine (counterpart of
``repro/core/embedding/common.py``).

The tables of a group are concatenated along the row axis into one
*mega-table* ``[sum(V_t), D]`` with per-table row offsets. Ids use ``-1``
padding for variable hotness.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import EmbeddingTableConfig


@dataclasses.dataclass(frozen=True)
class TableGroup:
    """A group of tables sharing one mega-table and one strategy."""
    strategy: str
    tables: Tuple[EmbeddingTableConfig, ...]
    #: row offset of each table within the mega-table
    offsets: Tuple[int, ...]
    total_rows: int
    dim: int
    #: index of each table in the *original* collection order
    table_indices: Tuple[int, ...]

    @property
    def num_tables(self) -> int:
        return len(self.tables)

    def table_rows(self, i: int) -> Tuple[int, int]:
        """``(start, stop)`` of table ``i`` within the mega-table."""
        stop = self.offsets[i + 1] if i + 1 < self.num_tables \
            else self.total_rows
        return self.offsets[i], stop


def build_group(strategy: str, tables: Sequence[EmbeddingTableConfig],
                table_indices: Sequence[int],
                rows_fn: Optional[Callable[[EmbeddingTableConfig], int]]
                = None) -> TableGroup:
    """Concatenate ``tables`` into one mega-table layout.

    ``rows_fn(table) -> int`` overrides the per-table row count (the
    hybrid strategy's hot-only and cold-only groups).
    """
    rows_fn = rows_fn or (lambda t: t.vocab_size)
    dims = {t.dim for t in tables}
    if len(dims) != 1:
        raise ValueError(f"grouped tables must share dim, got {dims}")
    offsets, total = [], 0
    for t in tables:
        offsets.append(total)
        total += rows_fn(t)
    return TableGroup(strategy, tuple(tables), tuple(offsets), total,
                      dims.pop(), tuple(table_indices))


def init_mega_table(generator: torch.Generator, group: TableGroup, *,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """Uniform(-1/sqrt(V), 1/sqrt(V)) per table (V the table's whole
    vocabulary, also for a hot or cold part), HugeCTR-style init, drawn
    on the CPU from ``generator`` table by table (so a seed gives the same
    table on every device) into one mega-table on ``device``."""
    out = torch.empty((group.total_rows, group.dim), dtype=dtype,
                      device=device)
    for i, t in enumerate(group.tables):
        lo, hi = group.table_rows(i)
        scale = 1.0 / math.sqrt(max(t.vocab_size, 1))
        u = torch.rand((hi - lo, group.dim), generator=generator,
                       dtype=torch.float32)
        out[lo:hi] = (u * (2 * scale) - scale).to(device=device, dtype=dtype)
    return out


def global_row_ids(ids: torch.Tensor, group: TableGroup) -> torch.Tensor:
    """Map per-table ids ``[..., T, H]`` to int32 mega-table row ids (keep
    -1)."""
    offs = torch.tensor(group.offsets, dtype=torch.int32,
                        device=ids.device).reshape(
        (1,) * (ids.dim() - 2) + (group.num_tables, 1))
    return torch.where(ids >= 0, ids.to(torch.int32) + offs,
                       torch.full_like(ids, -1, dtype=torch.int32))


def pooled_local_lookup(mega: torch.Tensor, rows: torch.Tensor,
                        combiner: str = "sum",
                        compute_dtype=None) -> torch.Tensor:
    """Plain gather + pool: ``rows [B, T, H]`` (-1 = pad) -> ``[B, T, D]``,
    each row cast to ``compute_dtype`` before the sum as the reference's
    pure-jnp path does."""
    valid = rows >= 0
    safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
    vecs = mega[safe]                                  # [B, T, H, D]
    if compute_dtype is not None:
        vecs = vecs.to(compute_dtype)
    vecs = torch.where(valid[..., None], vecs,
                       torch.zeros((), dtype=vecs.dtype, device=vecs.device))
    pooled = vecs.sum(dim=-2)
    if combiner == "mean":
        pooled = pooled / combiner_mask_denom(rows).to(pooled.dtype)
    return pooled


def masked_range_lookup(local: torch.Tensor, rows: torch.Tensor, v0: int,
                        combiner: str = "sum", compute_dtype=None,
                        pool_fn: Optional[Callable] = None) -> torch.Tensor:
    """Partial pooled lookup against a row-range shard ``[v0, v0 + len)``:
    rows outside the shard become -1 holes and contribute zero, so summing
    the partials across shards gives the full pooled lookup (the mean
    renorm is the caller's: ``combiner`` is taken and ignored, as in the
    reference). ``pool_fn(local, rows, compute_dtype=...)`` pools
    (``kernels.ops.kernel_pool``: K1 forward, K3 backward); the plain
    :func:`pooled_local_lookup` by default."""
    rel = rows - v0
    valid = (rows >= 0) & (rel >= 0) & (rel < local.shape[0])
    rel = torch.where(valid, rel, torch.full_like(rel, -1))
    pool = pool_fn or pooled_local_lookup
    return pool(local, rel, compute_dtype=compute_dtype)


def combiner_mask_denom(rows: torch.Tensor) -> torch.Tensor:
    """Denominator for mean-combining given padded rows ``[..., H]``."""
    return (rows >= 0).sum(dim=-1, keepdim=True).clamp_min(1)
