"""Configuration dataclasses, copied from ``repro.configs.base``.

Field names, order and defaults are identical to the JAX package's, so
``recsys_config_hash`` is byte-identical and a ``graph.json``/``ps.json``
written by either package verifies in the other. The LM side's
``LMConfig``/``MoEConfig`` and the input shapes are copied the same way.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Optional, Tuple, Union

# embedding placement strategies (the planner's vocabulary)
LOCALIZED = "localized"      # whole table on one device, all-to-all after pool
DISTRIBUTED = "distributed"  # rows striped across all devices (MP)
HYBRID = "hybrid"            # hot rows replicated (DP), cold rows striped (MP)
DATA_PARALLEL = "data_parallel"  # fully replicated (small tables)


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

    @property
    def param_count(self) -> int:
        return self.vocab_size * self.dim


@dataclasses.dataclass(frozen=True)
class SparseGroupConfig:
    """One extra embedding group beyond the primary tables (an N-group
    model's independently-dimensioned ``SparseEmbedding``): its own
    ``EmbeddingCollection`` under param key ``embedding@<name>`` and its
    own HPS at serve time. ``name`` is the group's graph tensor name; all
    its tables share ``dim``."""
    name: str
    tables: Tuple[EmbeddingTableConfig, ...]
    dim: int


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
    #: model == "graph" only: the serialized dense-layer DAG, one
    #: ("inputs", dense, emb, wide[, extras]) header and one (type,
    #: bottoms, top, attrs) tuple per layer (``dense_graph.graph_spec``)
    dense_graph: Tuple = ()
    #: model == "graph" only: whether a dim-1 wide twin branch exists
    wide_branch: bool = False
    #: model == "graph" only: the embedding groups past the primary
    #: ``tables``, in declared order
    extra_groups: Tuple[SparseGroupConfig, ...] = ()

    @property
    def num_tables(self) -> int:
        return len(self.tables)

    @property
    def all_tables(self) -> Tuple[EmbeddingTableConfig, ...]:
        """The primary tables, then each extra group's: the ``cat``
        column layout."""
        out = tuple(self.tables)
        for g in self.extra_groups:
            out += tuple(g.tables)
        return out

    @property
    def total_embedding_params(self) -> int:
        return sum(t.param_count for t in self.all_tables)


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
    tables = tuple(EmbeddingTableConfig(**t) for t in d["tables"])
    rest = {k: v for k, v in d.items() if k != "tables"}
    for k in ("bottom_mlp", "top_mlp"):
        rest[k] = tuple(rest[k])
    if rest.get("dense_graph"):
        from repro_torch.models.recsys.dense_graph import (
            dense_graph_from_jsonable)
        rest["dense_graph"] = dense_graph_from_jsonable(rest["dense_graph"])
    if rest.get("extra_groups"):
        rest["extra_groups"] = tuple(
            SparseGroupConfig(
                name=g["name"],
                tables=tuple(EmbeddingTableConfig(**t) for t in g["tables"]),
                dim=g["dim"])
            for g in rest["extra_groups"])
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


@dataclasses.dataclass
class ETCParams:
    """Embedding Training Cache knobs (``Solver(etc=ETCParams(...))``).

    Declares that ``fit()`` should train the embedding tables through the
    ETC — a fixed-capacity device row cache staged against a host/disk
    parameter server — instead of holding every table in device memory
    (the paper's §1 "Online training" / incremental-training mode).

    * ``cache_rows`` — device cache capacity per table (rows).
    * ``ps`` — parameter-server tier: ``"staged"`` (host memory) or
      ``"cached"`` (disk memmaps under ``ps_root``).
    * ``ps_root`` — directory for the cached PS tables (required when
      ``ps="cached"``); reopening the same root resumes training from
      the flushed state.
    * ``ps_shards`` — staged-PS shard count (simulated cluster spread).
    * ``passes`` — keyset-staged passes per ``fit()``: the step budget
      splits into this many passes, each pass pre-stages its keyset
      (the hottest ids of its data window) before stepping and flushes
      the cache back to the PS at the pass boundary — HugeCTR's
      ``wdl_etc`` source-per-pass workflow.

    JSON round-trips through ``Solver`` serialization (graph.json), so a
    deployed graph remembers how it was trained.
    """
    cache_rows: int = 4096
    ps: str = "staged"
    ps_root: Optional[str] = None
    ps_shards: int = 1
    passes: int = 1

    def __post_init__(self):
        if self.ps not in ("staged", "cached"):
            raise ValueError(
                f"ETCParams.ps must be 'staged' or 'cached', got "
                f"{self.ps!r}")
        if self.cache_rows <= 0:
            raise ValueError(
                f"ETCParams.cache_rows must be positive, got "
                f"{self.cache_rows}")
        if self.ps_shards <= 0:
            raise ValueError(
                f"ETCParams.ps_shards must be positive, got "
                f"{self.ps_shards}")
        if self.passes <= 0:
            raise ValueError(
                f"ETCParams.passes must be positive, got {self.passes}")
        if self.ps == "cached" and not self.ps_root:
            raise ValueError(
                "ETCParams(ps='cached') needs ps_root (the memmap "
                "directory)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (the JAX package's field set and
    defaults)."""
    learning_rate: float = 1e-3
    dense_optimizer: str = "adamw"    # "sgd" | "adam" | "adamw"
    sparse_optimizer: str = "rowwise_adagrad"  # HugeCTR's default for tables
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    mixed_precision: bool = True      # bf16 compute, f32 master weights
    grad_allreduce_dtype: str = "f32" # "bf16" enables compressed all-reduce
    remat: str = "none"               # "none" | "full" | "dots"
    microbatches: int = 1             # grad accumulation splits


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """A device layout as the placement planner sees it."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


#: one device, laid out as the reference lays out a one-device test mesh
SINGLE_DEVICE = MeshConfig((1, 1), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    """A multi-model deployment bundle: several models' parameter-server
    specs served from ONE storage backend process.

    All member configs share one ``pdb_root`` (the PDB namespaces tables
    per model) and, at serve time, one VolatileDB and one message bus.
    """
    models: Tuple[HPSConfig, ...]

    def __post_init__(self):
        names = [m.model for m in self.models]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names in ensemble: {names}")
        roots = {m.pdb_root for m in self.models}
        if len(roots) != 1:
            raise ValueError(
                f"ensemble members must share one pdb_root, got {roots}")


def ensemble_config_to_dict(cfg: EnsembleConfig) -> Dict:
    return {"format": "repro-ps-ensemble-v1",
            "models": [hps_config_to_dict(m) for m in cfg.models]}


def ensemble_config_from_dict(d: Dict) -> EnsembleConfig:
    if d.get("format") != "repro-ps-ensemble-v1":
        raise ValueError(f"unknown ensemble format {d.get('format')!r}")
    return EnsembleConfig(models=tuple(hps_config_from_dict(m)
                                       for m in d["models"]))


def ps_config_from_dict(d: Dict) -> Union[HPSConfig, EnsembleConfig]:
    """Format-sniffing loader: a ps.json holds either one model's
    :class:`HPSConfig` or a multi-model :class:`EnsembleConfig`."""
    if d.get("format") == "repro-ps-ensemble-v1":
        return ensemble_config_from_dict(d)
    return hps_config_from_dict(d)


# ---------------------------------------------------------------------------
# LM-family architectures
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                      # "dense"|"moe"|"audio"|"vlm"|"ssm"|"hybrid"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm" | "nonparam_ln"
    activation: str = "swiglu"       # "swiglu" | "gelu" | "relu_sq" | "geglu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    # hybrid/ssm block pattern: e.g. ("rglru","rglru","local_attn") repeated
    block_pattern: Tuple[str, ...] = ("attn",)
    local_attn_window: int = 2048    # for "local_attn" blocks
    # enc-dec (seamless): encoder layers, 0 = decoder-only
    encoder_layers: int = 0
    # modality frontend stub: ("audio", frames_dim) / ("vision", patch_dim)
    frontend: Optional[str] = None   # None | "audio" | "vision"
    frontend_seq: int = 0            # stub frontend sequence length
    #: whether full quadratic attention is the only mixer (skips long_500k)
    full_attention_only: bool = True
    dtype: str = "bf16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def dense_param_count(self) -> int:
        """Rough non-embedding parameter count (for 6ND napkin math)."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.moe is not None:
            ffn = self.moe.num_experts * 3 * d * self.moe.expert_d_ff \
                + d * self.moe.num_experts
        elif self.activation in ("swiglu", "geglu"):
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        total_layers = L + self.encoder_layers
        return total_layers * (attn + ffn)

    @property
    def active_param_count(self) -> int:
        """Active (per-token) params — differs from dense for MoE."""
        if self.moe is None:
            return self.dense_param_count
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        ffn = self.moe.top_k * 3 * d * self.moe.expert_d_ff \
            + d * self.moe.num_experts
        return L * (attn + ffn)

    @property
    def embedding_param_count(self) -> int:
        n = self.vocab_size * self.d_model
        return n if self.tie_embeddings else 2 * n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                 # "train_4k" | "prefill_32k" | ...
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

LM_SHAPE_BY_NAME = {s.name: s for s in LM_SHAPES}
