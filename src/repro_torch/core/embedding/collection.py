"""EmbeddingCollection on one device (counterpart of
``repro/core/embedding/collection.py``).

Tables are grouped by the strategy the planner resolved: ``dp``
(data-parallel, replicated), ``dist`` (distributed, row-sharded) and the
``hybrid`` split into ``hot`` (each table's first ``round(V *
hot_fraction)`` rows, replicated) and ``cold`` (the rest, row-sharded). On
one device every group is a plain mega-table and the reference's
collectives are identities, so every group pools through the same lookup:
the kernel path ``kernels/ops.kernel_pool`` (K1 forward, K3 backward) or,
with ``use_kernels=False``, the plain ``pooled_local_lookup``; a hybrid
table's output is its hot part's pool plus its cold part's. The groups
are kept because the checkpoint and deploy layouts (``export_logical``
keys) depend on them.

At one id per table row the pooled values equal the reference's exactly;
with several ids in bf16 compute the kernel path sums in f32 and rounds
once, where the reference's ``dist`` path rounds every row first.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (
    DATA_PARALLEL, DISTRIBUTED, HYBRID, EmbeddingTableConfig,
)
from repro_torch.core.embedding.common import (
    TableGroup, build_group, combiner_mask_denom, global_row_ids,
    init_mega_table, pooled_local_lookup,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.roadmap import MULTI_DEVICE, not_ported


class EmbeddingCollection:
    """``comm`` is the reference's knob: on one device ``"allgather_rs"``
    and ``"auto"`` are the one pooled lookup; a pinned ``"all_to_all"``,
    like a ``localized`` table, raises."""

    def __init__(self, tables: Sequence[EmbeddingTableConfig], *,
                 comm: str = "allgather_rs",
                 compute_dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None, use_kernels: bool = True):
        if comm == "all_to_all":
            raise not_ported('comm="all_to_all"', MULTI_DEVICE)
        if comm not in ("auto", "allgather_rs"):
            raise ValueError(f"unknown comm {comm!r}")
        for t in tables:
            if t.strategy == "auto":
                raise ValueError(
                    f"table {t.name}: run planner.resolve_strategies first")
            if t.strategy not in (DATA_PARALLEL, DISTRIBUTED, HYBRID):
                raise not_ported(f"table {t.name}: strategy {t.strategy!r}",
                                 MULTI_DEVICE)
        self.tables = tuple(tables)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.groups: Dict[str, TableGroup] = {}
        for key, strategy in (("dp", DATA_PARALLEL), ("dist", DISTRIBUTED)):
            members = [(i, t) for i, t in enumerate(self.tables)
                       if t.strategy == strategy]
            if members:
                self.groups[key] = build_group(
                    strategy, [t for _, t in members],
                    [i for i, _ in members])
        hyb = [(i, t) for i, t in enumerate(self.tables)
               if t.strategy == HYBRID]
        if hyb:
            hot = {t.name: min(t.vocab_size,
                               max(1, int(round(t.vocab_size *
                                                t.hot_fraction))))
                   for _, t in hyb}
            tabs, idx = [t for _, t in hyb], [i for i, _ in hyb]
            gh = self.groups["hot"] = build_group(
                HYBRID, tabs, idx, rows_fn=lambda t: hot[t.name])
            gc = self.groups["cold"] = build_group(
                HYBRID, tabs, idx, rows_fn=lambda t: t.vocab_size - hot[t.name])
            col = lambda v: torch.tensor(v, dtype=torch.int32,
                                         device=self.device)[None, :, None]
            self._hot_n = col([hot[t.name] for t in tabs])
            self._hot_off, self._cold_off = col(gh.offsets), col(gc.offsets)
        # output column permutation: concat(group outputs) -> original order
        # (hot and cold give one output column set, listed once)
        order = [i for k, g in self.groups.items() if k != "cold"
                 for i in g.table_indices]
        inv = np.empty(len(self.tables), np.int64)
        inv[np.asarray(order, np.int64)] = np.arange(len(order))
        self._inv_perm = torch.from_numpy(inv).to(self.device)
        self._group_cols = {k: torch.tensor(g.table_indices, dtype=torch.long,
                                            device=self.device)
                            for k, g in self.groups.items()}
        mean = [t.combiner == "mean" for t in self.tables]
        self._mean = torch.tensor(mean, device=self.device) \
            if any(mean) else None

    # -- params -------------------------------------------------------------

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """One mega-table per group, drawn from ``generator`` (``dp``
        first, then ``dist``)."""
        return {k: init_mega_table(generator, g, dtype=dtype,
                                   device=self.device)
                for k, g in self.groups.items()}

    # -- lookup -------------------------------------------------------------

    def group_rows(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``ids [B, T, H]`` (per-table local ids, -1 pad) -> each group's
        mega-table row ids ``[B, T_g, H]`` int32 (-1 pad); an id of a
        hybrid table lands in ``hot`` or in ``cold``, -1 in the other."""
        rows = {}
        for key in ("dp", "dist"):
            if key in self.groups:
                rows[key] = global_row_ids(ids[:, self._group_cols[key], :],
                                           self.groups[key])
        if "hot" in self.groups:
            tids = ids[:, self._group_cols["hot"], :]
            neg = torch.full_like(tids, -1, dtype=torch.int32)
            rows["hot"] = torch.where((tids >= 0) & (tids < self._hot_n),
                                      tids + self._hot_off, neg)
            rows["cold"] = torch.where(tids >= self._hot_n,
                                       tids - self._hot_n + self._cold_off,
                                       neg)
        return rows

    def lookup(self, params: Dict[str, torch.Tensor],
               ids: torch.Tensor) -> torch.Tensor:
        """``ids [B, T, H]`` (per-table local ids, -1 pad) -> ``[B, T, D]``
        in the compute dtype."""
        rows = self.group_rows(ids)
        outs = [self._pool(params[k], rows[k]) for k in ("dp", "dist")
                if k in rows]
        if "hot" in rows:
            outs.append(self._pool(params["hot"], rows["hot"])
                        + self._pool(params["cold"], rows["cold"]))
        out = torch.cat(outs, dim=1)[:, self._inv_perm, :]
        if self._mean is not None:
            denom = combiner_mask_denom(ids).to(out.dtype)
            out = torch.where(self._mean[None, :, None], out / denom, out)
        return out

    def _pool(self, mega: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        if self.use_kernels:
            return kops.kernel_pool(mega, rows,
                                    compute_dtype=self.compute_dtype)
        return pooled_local_lookup(mega, rows,
                                   compute_dtype=self.compute_dtype)

    # -- layout conversion (checkpoint / deploy) -----------------------------

    def export_logical(self, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """Mega-tables in the reference's logical (mesh-independent,
        unpadded) layout. On one device the physical layout is the logical
        one, so this only drops any rows past each group's end."""
        return {k: v[:self.groups[k].total_rows] for k, v in params.items()}

    def import_logical(self, logical: Dict) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`export_logical`: arrays or tensors -> f32
        tensors on the collection's device (rows past a group's end, such
        as another mesh's pad, are dropped)."""
        out = {}
        for k, v in logical.items():
            g = self.groups[k]
            v = torch.as_tensor(v)
            if v.shape[0] < g.total_rows or v.shape[1] != g.dim:
                raise ValueError(
                    f"embedding group {k!r}: checkpoint has "
                    f"{tuple(v.shape)}, need ({g.total_rows}, {g.dim})")
            out[k] = v[:g.total_rows].to(device=self.device,
                                         dtype=torch.float32).contiguous()
        return out

    def logical_tables(self, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
        """Per-table ``[V, D]`` f32 weights keyed by table name (what the
        PDB and the bundle hold)."""
        out: Dict[str, np.ndarray] = {}
        for k, g in self.groups.items():
            if k == "cold":
                continue                   # merged into "hot" below
            for i, t in enumerate(g.tables):
                lo, hi = g.table_rows(i)
                full = params[k].detach()[lo:hi]
                if k == "hot":
                    clo, chi = self.groups["cold"].table_rows(i)
                    full = torch.cat([full, params["cold"].detach()[clo:chi]])
                out[t.name] = full.float().cpu().numpy()
        return out
