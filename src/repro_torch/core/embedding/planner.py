"""Placement planner, copied from ``repro/core/embedding/planner.py``
(``plan`` and ``resolve_strategies``), so the port makes the same embedding
groups as the reference for the same tables, device layout and batch.

Cost model (per training step, per device, bytes):
  data_parallel : fwd 0, bwd all-reduce of the dense grad  ~ 2·V·D·s
  distributed   : ag_rs — RS(B_g·D·s) + AG_model(B_dp·D·s) per table
                  a2a  — 2 · B_dp·H·D·s request/response traffic
  hybrid        : hot hits free (DP, replicated) + cold via distributed on
                  (1-cov) of the traffic.
Tables of at most 1 MiB are replicated whatever the costs say.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from repro_torch.configs.base import (
    DATA_PARALLEL, DISTRIBUTED, HYBRID, LOCALIZED,
    EmbeddingTableConfig, MeshConfig,
)


@dataclasses.dataclass
class PlacementDecision:
    table: str
    strategy: str
    comm_bytes: float          # estimated per-device per-step
    mem_bytes: float           # per-device
    note: str = ""


def plan(tables: Sequence[EmbeddingTableConfig],
         mesh: MeshConfig,
         global_batch: int,
         *,
         bytes_per_elem: int = 4,
         dp_mem_budget: float = 64 * 2 ** 20,
         hot_coverage: float = 0.9,
         ) -> Dict[str, PlacementDecision]:
    """Decide a strategy for every table whose config says ``auto``."""
    n = mesh.num_devices
    model = mesh.shape[-1]
    dp = max(1, n // model)
    b_dp = max(1, global_batch // dp)
    out: Dict[str, PlacementDecision] = {}
    for t in tables:
        if t.strategy != "auto":
            out[t.name] = PlacementDecision(t.name, t.strategy, 0.0,
                                            _mem(t, t.strategy, n,
                                                 bytes_per_elem),
                                            "pinned by config")
            continue
        s = bytes_per_elem
        d = t.dim
        cost = {
            DATA_PARALLEL: 2.0 * t.vocab_size * d * s,           # grad AR
            DISTRIBUTED: min(
                global_batch * d * s + (b_dp * d * s) * (model - 1) / model,
                2.0 * b_dp * t.hotness * d * s),
            HYBRID: (1.0 - hot_coverage) * 2.0 * b_dp * t.hotness * d * s
            + 2.0 * int(t.vocab_size * t.hot_fraction) * d * s,
        }
        mem_dp = t.vocab_size * d * s
        feasible = dict(cost)
        if mem_dp > dp_mem_budget:
            feasible.pop(DATA_PARALLEL, None)
        strategy = min(feasible, key=feasible.get)
        # tiny tables: replicate regardless (communication ~ 0 anyway)
        if mem_dp <= 2 ** 20:
            strategy = DATA_PARALLEL
        out[t.name] = PlacementDecision(
            t.name, strategy, feasible.get(strategy, 0.0),
            _mem(t, strategy, n, bytes_per_elem),
            f"costs={ {k: f'{v:.2e}' for k, v in cost.items()} }")
    return out


def _mem(t: EmbeddingTableConfig, strategy: str, n: int, s: int) -> float:
    full = t.vocab_size * t.dim * s
    if strategy in (DATA_PARALLEL, LOCALIZED):
        return full
    if strategy == DISTRIBUTED:
        return full / n
    if strategy == HYBRID:
        hot = int(t.vocab_size * t.hot_fraction) * t.dim * s
        return hot + (full - hot) / n
    return full


def resolve_strategies(tables: Sequence[EmbeddingTableConfig],
                       mesh: MeshConfig, global_batch: int,
                       ) -> Tuple[EmbeddingTableConfig, ...]:
    """Return tables with ``auto`` strategies replaced by planner picks."""
    decisions = plan(tables, mesh, global_batch)
    resolved = []
    for t in tables:
        strat = decisions[t.name].strategy if t.strategy == "auto" \
            else t.strategy
        resolved.append(dataclasses.replace(t, strategy=strat))
    return tuple(resolved)
