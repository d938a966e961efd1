"""EmbeddingCollection (counterpart of
``repro/core/embedding/collection.py``): the paper's embedding engine.

Tables are grouped by the strategy the planner resolved: ``dp``
(data-parallel, replicated), ``dist`` (distributed, row-sharded), ``loc``
(localized: whole tables a device, ``[T, V_max, D]``) and the ``hybrid``
split into ``hot`` (each table's first ``round(V * hot_fraction)`` rows,
replicated) and ``cold`` (the rest, row-sharded).

Without a ``mesh`` the collection lives on one device: every sharded group
is its whole mega-table, the reference's collectives are identities, and
every group pools through one lookup: the kernel path
``kernels/ops.kernel_pool`` (K1 forward, K3 backward) or, with
``use_kernels=False``, the plain ``pooled_local_lookup``; a hybrid table's
output is its hot part's pool plus its cold part's.

On a ``mesh`` (a ``launch.mesh`` DeviceMesh; one rank a device) each rank
holds its own block of the sharded groups and looks up its data-parallel
batch block through ``strategies``: ``dist`` and ``cold`` by
``distributed_ag_rs`` (``comm="allgather_rs"``) or ``distributed_a2a``
(``"all_to_all"``), ``loc`` by ``localized``. Their physical layout is
that of the reference:

  * ``block``   — contiguous row ranges a shard (all-gather +
    reduce-scatter),
  * ``striped`` — row ``r`` on shard ``r % N`` at slot ``r // N``
    (HugeCTR's hash sharding; all-to-all),

each padded to ``[R_pad, D]`` with ``R_pad`` a multiple of the shard
count, the pad rows zero. ``shard_axes="all"`` stripes the rows over every
mesh axis, ``"model"`` over the model axis alone (replicated over DP).
``export_logical`` gathers the shards into the reference's logical
(mesh-independent, unpadded) arrays on every rank, and ``import_logical``
takes such arrays back onto this collection's mesh, so a checkpoint moves
between mesh sizes and between the packages.

At one id per table row the pooled values equal the reference's exactly;
with several ids in bf16 compute the kernel path sums in f32 and rounds
once, where the reference rounds every row first.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (
    DATA_PARALLEL, DISTRIBUTED, HYBRID, LOCALIZED, EmbeddingTableConfig,
)
from repro_torch.core.embedding import strategies
from repro_torch.core.embedding.common import (
    TableGroup, build_group, combiner_mask_denom, global_row_ids,
    init_mega_table, pooled_local_lookup,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as meshlib

COMMS = ("auto", "allgather_rs", "all_to_all")
#: the groups whose rows are sharded over the mesh (the rest replicate)
SHARDED_GROUPS = ("dist", "loc", "cold")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class EmbeddingCollection:
    """``comm`` is the reference's exchange knob for the sharded groups
    (``"auto"`` is ``"allgather_rs"`` here; the model resolves it per
    collection with ``planner.choose_comm``); ``capacity_factor`` sizes
    the all-to-all's buckets."""

    def __init__(self, tables: Sequence[EmbeddingTableConfig], *,
                 mesh=None, comm: str = "allgather_rs",
                 capacity_factor: float = 2.0,
                 compute_dtype: Optional[torch.dtype] = None,
                 shard_axes: str = "all",
                 device: DeviceLike = None, use_kernels: bool = True):
        if comm not in COMMS:
            raise ValueError(f"unknown comm {comm!r}")
        if shard_axes not in ("all", "model"):
            raise ValueError(f"shard_axes must be 'all' or 'model', got "
                             f"{shard_axes!r}")
        for t in tables:
            if t.strategy == "auto":
                raise ValueError(
                    f"table {t.name}: run planner.resolve_strategies first")
        self.tables = tuple(tables)
        self.mesh = mesh
        self.comm = comm
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.use_kernels = use_kernels
        self.device = (meshlib.mesh_device(mesh) if mesh is not None
                       else resolve_device(device))
        if mesh is not None:
            axes = meshlib.all_axes(mesh)
            self.all_axes: Tuple[str, ...] = axes
            self.model_axis = "model" if "model" in axes else axes[-1]
            self.dp_axes = tuple(a for a in axes if a != self.model_axis)
            self.n_devices = meshlib.mesh_size(mesh)
            if shard_axes == "model":
                self.shard_axes: Tuple[str, ...] = (self.model_axis,)
                self.gather_axes: Tuple[str, ...] = ()
            else:
                self.shard_axes, self.gather_axes = axes, self.dp_axes
            self.n_shards = meshlib.axis_size(mesh, self.shard_axes)
            self.shard_index = meshlib.axis_index(mesh, self.shard_axes)
            self.device_index = meshlib.axis_index(mesh, axes)
        else:
            self.n_devices = self.n_shards = 1
            self.shard_index = self.device_index = 0
        self.groups: Dict[str, TableGroup] = {}
        for key, strategy in (("dp", DATA_PARALLEL), ("dist", DISTRIBUTED),
                              ("loc", LOCALIZED)):
            members = [(i, t) for i, t in enumerate(self.tables)
                       if t.strategy == strategy]
            if members:
                self.groups[key] = build_group(
                    strategy, [t for _, t in members],
                    [i for i, _ in members])
        if "loc" in self.groups:
            n_loc = self.groups["loc"].num_tables
            if n_loc % self.n_devices:
                raise ValueError(
                    f"localized needs #tables ({n_loc}) divisible by "
                    f"#devices ({self.n_devices}); planner avoids this")
            self._loc_vmax = max(t.vocab_size
                                 for t in self.groups["loc"].tables)
            self._loc_per_shard = n_loc // self.n_devices
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
        self.layout = "striped" if comm == "all_to_all" else "block"

    # -- layout ---------------------------------------------------------------

    def _padded_rows(self, g: TableGroup) -> int:
        return _round_up(max(g.total_rows, self.n_shards), self.n_shards)

    def _physical_of_logical(self, rpad: int) -> torch.Tensor:
        """Physical row of each logical row (the striped layout)."""
        n = self.n_shards
        r = torch.arange(rpad)
        return (r % n) * (rpad // n) + r // n

    def _logical_of_physical(self, rpad: int) -> torch.Tensor:
        n = self.n_shards
        shard = rpad // n
        p = torch.arange(rpad)
        return (p % shard) * n + p // shard

    def sharded_keys(self) -> Tuple[str, ...]:
        """Param keys of the groups sharded over a mesh (on one, their
        tensors are this rank's shard)."""
        return tuple(k for k in SHARDED_GROUPS if k in self.groups)

    def replica_axes(self, key: str) -> Optional[Tuple[str, ...]]:
        """The mesh axes group ``key``'s tensor is replicated over, whose
        gradient contributions sum over them: None for a replicated group
        (every axis), ``()`` for one sharded over every axis, the DP axes
        for rows striped over ``"model"`` alone. ``()`` without a mesh."""
        if self.mesh is None:
            return ()
        if key not in SHARDED_GROUPS:
            return None
        if key == "loc":
            return ()
        return tuple(a for a in self.all_axes if a not in self.shard_axes)

    # -- params -------------------------------------------------------------

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """One logical mega-table a group (``loc``: ``[T, V_max, D]`` with
        zero pad rows), drawn from ``generator`` group by group, table by
        table; on a mesh, each rank keeps its shard of them (the same
        weights as one device for the same seed)."""
        logical = {}
        for k, g in self.groups.items():
            if k == "loc":
                logical[k] = torch.stack([
                    torch.cat([init_mega_table(
                        generator, build_group(LOCALIZED, [t], [0]),
                        dtype=dtype, device=self.device),
                        torch.zeros((self._loc_vmax - t.vocab_size, g.dim),
                                    dtype=dtype, device=self.device)])
                    for t in g.tables])
            else:
                logical[k] = init_mega_table(generator, g, dtype=dtype,
                                             device=self.device)
        return logical if self.mesh is None else self.import_logical(logical)

    # -- lookup -------------------------------------------------------------

    def group_rows(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``ids [B, T, H]`` (per-table local ids, -1 pad) -> each group's
        mega-table row ids ``[B, T_g, H]`` int32 (-1 pad); an id of a
        hybrid table lands in ``hot`` or in ``cold``, -1 in the other;
        ``loc`` keeps its per-table ids."""
        rows = {}
        for key in ("dp", "dist"):
            if key in self.groups:
                rows[key] = global_row_ids(ids[:, self._group_cols[key], :],
                                           self.groups[key])
        if "loc" in self.groups:
            rows["loc"] = ids[:, self._group_cols["loc"], :]
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
        """``ids [B, T, H]`` (per-table local ids, -1 pad; on a mesh this
        rank's data-parallel block) -> ``[B, T, D]`` in the compute
        dtype."""
        rows = self.group_rows(ids)
        outs = []
        if "dp" in rows:
            outs.append(self._pool(params["dp"], rows["dp"]))
        if "dist" in rows:
            outs.append(self._dist_lookup(params["dist"], rows["dist"],
                                          self.groups["dist"]))
        if "loc" in rows:
            outs.append(self._loc_lookup(params["loc"], rows["loc"]))
        if "hot" in rows:
            outs.append(self._pool(params["hot"], rows["hot"])
                        + self._dist_lookup(params["cold"], rows["cold"],
                                            self.groups["cold"]))
        out = torch.cat(outs, dim=1)[:, self._inv_perm, :]
        if self._mean is not None:
            denom = combiner_mask_denom(ids).to(out.dtype)
            out = torch.where(self._mean[None, :, None], out / denom, out)
        return out

    def _pool_fn(self):
        return kops.kernel_pool if self.use_kernels else pooled_local_lookup

    def _pool(self, mega: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        return self._pool_fn()(mega, rows, compute_dtype=self.compute_dtype)

    def _dist_lookup(self, mega: torch.Tensor, rows: torch.Tensor,
                     g: TableGroup) -> torch.Tensor:
        if self.mesh is None:
            return self._pool(mega, rows)
        if self.comm == "all_to_all":
            return strategies.distributed_a2a(
                mega, rows, mesh=self.mesh, all_axes=self.shard_axes,
                n_shards=self.n_shards,
                capacity_factor=self.capacity_factor,
                compute_dtype=self.compute_dtype,
                gather_fn=kops.row_gather if self.use_kernels else None)
        return strategies.distributed_ag_rs(
            mega, rows, mesh=self.mesh, dp_axes=self.gather_axes,
            all_axes=self.shard_axes, model_axis=self.model_axis,
            shard_rows=self._padded_rows(g) // self.n_shards,
            compute_dtype=self.compute_dtype, pool_fn=self._pool_fn())

    def _loc_lookup(self, tables: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return strategies.local_tables_pool(
                tables, ids, compute_dtype=self.compute_dtype,
                pool_fn=self._pool_fn())
        return strategies.localized(
            tables, ids, mesh=self.mesh, dp_axes=self.dp_axes,
            all_axes=self.all_axes, model_axis=self.model_axis,
            tables_per_shard=self._loc_per_shard,
            compute_dtype=self.compute_dtype, pool_fn=self._pool_fn())

    # -- layout conversion (checkpoint / deploy) -----------------------------

    def _shard_group(self, key: str):
        axes = self.all_axes if key == "loc" else self.shard_axes
        return meshlib.axis_group(self.mesh, axes)

    def export_logical(self, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """Mega-tables in the reference's logical (mesh-independent,
        unpadded, de-striped) layout. On a mesh every rank gathers the
        shards (a collective: every rank of the mesh calls it) and gets
        the whole arrays; on one device this drops rows past each group's
        end."""
        out = {}
        for k, v in params.items():
            g = self.groups[k]
            v = v.detach()
            if self.mesh is not None and k in SHARDED_GROUPS:
                v = strategies.all_gather(v, self._shard_group(k))
                if k != "loc" and self.layout == "striped":
                    v = v[self._physical_of_logical(v.shape[0])
                          .to(v.device)]
            out[k] = v if k == "loc" else v[:g.total_rows]
        return out

    def import_logical(self, logical: Dict) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`export_logical` for THIS collection: arrays
        or tensors -> f32 tensors on the collection's device, each sharded
        group as this rank's block. Rows past a group's logical end (such
        as another mesh's pad) are dropped and the pad rows of this
        layout freshly zeroed."""
        out = {}
        for k, v in logical.items():
            g = self.groups[k]
            v = torch.as_tensor(v).to(torch.float32)
            if k == "loc":
                want = (g.num_tables, self._loc_vmax, g.dim)
                if tuple(v.shape) != want:
                    raise ValueError(
                        f"embedding group 'loc': checkpoint has "
                        f"{tuple(v.shape)}, need {want}")
                if self.mesh is not None:
                    t0 = self.device_index * self._loc_per_shard
                    v = v[t0:t0 + self._loc_per_shard]
                out[k] = v.to(self.device).contiguous()
                continue
            if v.shape[0] < g.total_rows or v.shape[1] != g.dim:
                raise ValueError(
                    f"embedding group {k!r}: checkpoint has "
                    f"{tuple(v.shape)}, need ({g.total_rows}, {g.dim})")
            v = v[:g.total_rows]
            if self.mesh is not None and k in SHARDED_GROUPS:
                rpad = self._padded_rows(g)
                v = torch.cat([v, v.new_zeros((rpad - g.total_rows, g.dim))])
                if self.layout == "striped":
                    v = v[self._logical_of_physical(rpad).to(v.device)]
                shard = rpad // self.n_shards
                v = v[self.shard_index * shard:(self.shard_index + 1)
                      * shard]
            out[k] = v.to(self.device).contiguous()
        return out

    def export_acc(self, acc: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """The row-wise optimizer state of this collection's groups (one
        value a physical row; a ``loc`` table's one a table) as the
        reference's checkpoint holds it: whole and in the physical
        (padded, striped) layout. A collective on a mesh."""
        if self.mesh is None:
            return dict(acc)
        return {k: strategies.all_gather(v.detach(), self._shard_group(k))
                if k in SHARDED_GROUPS else v for k, v in acc.items()}

    def import_acc(self, acc: Dict) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`export_acc`: this rank's block of each
        sharded group's state, on the collection's device. A block-layout
        state from another mesh size is cut or zero-padded to this
        layout's rows (the pad rows never train, so theirs stay zero); a
        striped one must have this layout's rows."""
        out = {}
        for k, v in acc.items():
            v = torch.as_tensor(v).to(self.device, torch.float32)
            if self.mesh is not None and k == "loc":
                t0 = self.device_index * self._loc_per_shard
                v = v[t0:t0 + self._loc_per_shard]
            elif self.mesh is not None and k in SHARDED_GROUPS:
                rpad = self._padded_rows(self.groups[k])
                if v.shape[0] != rpad:
                    if self.layout == "striped":
                        raise ValueError(
                            f"optimizer state of group {k!r} has "
                            f"{v.shape[0]} striped rows, this mesh "
                            f"lays out {rpad}")
                    v = torch.cat([v[:rpad], v.new_zeros(
                        (max(0, rpad - v.shape[0]),))])
                shard = rpad // self.n_shards
                v = v[self.shard_index * shard:(self.shard_index + 1)
                      * shard]
            out[k] = v.contiguous()
        return out

    def logical_tables(self, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
        """Per-table ``[V, D]`` f32 weights keyed by table name (what the
        PDB and the bundle hold); on a mesh a collective, as
        :meth:`export_logical`."""
        logical = self.export_logical(params)
        out: Dict[str, np.ndarray] = {}
        for k, g in self.groups.items():
            if k == "cold":
                continue                   # merged into "hot" below
            for i, t in enumerate(g.tables):
                if k == "loc":
                    full = logical["loc"][i][:t.vocab_size]
                else:
                    lo, hi = g.table_rows(i)
                    full = logical[k][lo:hi]
                if k == "hot":
                    clo, chi = self.groups["cold"].table_rows(i)
                    full = torch.cat([full, logical["cold"][clo:chi]])
                out[t.name] = full.float().cpu().numpy()
        return out
