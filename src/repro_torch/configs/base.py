"""Configuration dataclasses, copied from ``repro.configs.base``.

Field names, order and defaults are identical to the JAX package's, so
``recsys_config_hash`` is byte-identical and a ``graph.json``/``ps.json``
written by either package verifies in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class EmbeddingTableConfig:
    """One categorical feature's embedding table."""
    name: str
    vocab_size: int
    dim: int
    #: number of ids per sample for this feature (1 = one-hot)
    hotness: int = 1
    #: "sum" | "mean" | "concat" (concat only valid for hotness == 1)
    combiner: str = "sum"
    #: placement strategy; "auto" lets the planner decide
    strategy: str = "auto"
    #: fraction of vocab treated as hot for HYBRID (planner may override)
    hot_fraction: float = 0.05


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                       # "dlrm"|"dcn"|"deepfm"|"wdl"|"graph"
    tables: Tuple[EmbeddingTableConfig, ...]
    num_dense_features: int
    bottom_mlp: Tuple[int, ...]
    top_mlp: Tuple[int, ...]
    embedding_dim: int               # shared D across tables (DLRM-style)
    num_cross_layers: int = 3        # DCN only
    dtype: str = "bf16"              # compute dtype
    #: model == "graph" only: the serialized dense-layer DAG
    dense_graph: Tuple = ()
    #: model == "graph" only: whether a dim-1 wide twin branch exists
    wide_branch: bool = False
    #: model == "graph" only: extra independently-dimensioned groups
    #: (kept so the field set, and so the hash, matches the reference)
    extra_groups: Tuple = ()

    @property
    def num_tables(self) -> int:
        return len(self.tables)


def recsys_config_to_dict(cfg: RecsysConfig) -> Dict:
    """Plain-JSON form (tuples become lists); default-valued graph fields
    are omitted exactly as the JAX package omits them."""
    d = dataclasses.asdict(cfg)
    if not d["dense_graph"]:
        del d["dense_graph"]
    if not d["wide_branch"]:
        del d["wide_branch"]
    if not d["extra_groups"]:
        del d["extra_groups"]
    return d


def recsys_config_from_dict(d: Dict) -> RecsysConfig:
    if d.get("dense_graph") or d.get("extra_groups"):
        raise NotImplementedError(
            "generic-graph and N-group configs are ported by the ROADMAP "
            "item 'The other recipes and graphs'")
    tables = tuple(EmbeddingTableConfig(**t) for t in d["tables"])
    rest = {k: v for k, v in d.items() if k != "tables"}
    for k in ("bottom_mlp", "top_mlp"):
        rest[k] = tuple(rest[k])
    return RecsysConfig(tables=tables, **rest)


def recsys_config_hash(cfg: RecsysConfig) -> str:
    """Stable content hash, embedded in serialized graphs and ps.json."""
    blob = json.dumps(recsys_config_to_dict(cfg), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class HPSConfig:
    """One deployed model's parameter-server spec (the ps.json content).

    Paths are relative to the directory holding ps.json, so the bundle
    (ps.json + graph.json + dense weights + PDB files) is relocatable.
    """
    model: str
    pdb_root: str
    graph_path: str
    dense_weights_path: str
    tables: Tuple[EmbeddingTableConfig, ...]
    #: wide models (wdl/deepfm) serve a second, dim-1 HPS
    wide: bool = False
    cache_capacity: int = 4096
    cache_shards: int = 1
    refresh_budget: int = 512
    max_batch: int = 1024
    #: L1 storage precision: "f32" (bit-exact), "f16", or "int8"
    payload_dtype: str = "f32"
    config_hash: str = ""

    def __post_init__(self):
        if self.payload_dtype not in ("f32", "f16", "int8"):
            raise ValueError(
                f"payload_dtype must be one of ('f32', 'f16', 'int8'), "
                f"got {self.payload_dtype!r}")


def hps_config_to_dict(cfg: HPSConfig) -> Dict:
    d = dataclasses.asdict(cfg)
    d["format"] = "repro-ps-v1"
    return d


def hps_config_from_dict(d: Dict) -> HPSConfig:
    if d.get("format", "repro-ps-v1") != "repro-ps-v1":
        raise ValueError(f"unknown ps config format {d.get('format')!r}")
    tables = tuple(EmbeddingTableConfig(**t) for t in d["tables"])
    rest = {k: v for k, v in d.items() if k not in ("tables", "format")}
    return HPSConfig(tables=tables, **rest)


def ps_config_from_dict(d: Dict) -> HPSConfig:
    """ps.json -> :class:`HPSConfig`. Ensemble bundles
    (``repro-ps-ensemble-v1``) are a later slice."""
    if d.get("format") == "repro-ps-ensemble-v1":
        raise NotImplementedError(
            "ensemble bundles (MultiModelServer) are ported by the ROADMAP "
            "item 'The rest of the serving engine'")
    return hps_config_from_dict(d)
