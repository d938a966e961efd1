"""HugeCTR-style declarative graph API on one device (counterpart of
``repro/api.py``).

The layer declarations (``Solver``, ``DataReaderParams``, ``Input``,
``SparseEmbedding``, ``DenseLayer``) carry the JAX package's field sets,
so a ``graph.json`` (format ``repro-graph-v1``) written by either package
loads in the other and lowers to the same ``recsys_config_hash``. Lowering
is the reference's: every graph is first compiled (the validation), then
the four paper recipes lower onto their canonical configs as the reference
recognises them: DLRM (bottom MLP, dot interaction, concat, top MLP), DCN
(concat, cross net and deep MLP, a 1-unit combine head), and Wide&Deep and
DeepFM, whose second ``SparseEmbedding`` group is the dim-1 twin of the
first (the wide branch; WDL's wide head becomes the first-order term,
DeepFM's ``fm`` layer its first- and second-order terms). Any other graph
lowers to ``model="graph"`` with its layer DAG embedded: a dim-1 twin group
still makes the wide branch, and every further ``SparseEmbedding`` group
is an extra group (``RecsysConfig.extra_groups``) with its own collection,
``cat`` columns and, deployed, its own HPS.

The paper's workflow runs through :class:`Model`::

    m = Model(solver, reader, name="dlrm"); m.add(...); ...
    m.compile(device="cuda")      # "cuda" unless device="cpu" is given
    m.fit(steps=100)              # synthetic reader, one device
    m.save("ckpt")                # graph.json + logical checkpoint
    server = m.deploy("bundle")   # pdb/ graph.json dense.npz ps.json

(``dlrm_graph`` / ``dcn_graph`` / ``wdl_graph`` / ``deepfm_graph`` and
``graph_model``, or ``recipe_graph``, declare a config's graph; the graph
recipes' ``build_model`` is in ``configs/*_criteo.py``).

and ``launch/serve.py::build_server_from_config`` (either package's)
serves the bundle; :func:`deploy_ensemble` writes one bundle for several
models, served by one ``MultiModelServer``. ``Solver(etc=ETCParams(...))``
routes ``fit()`` through the Embedding Training Cache
(``repro_torch.online.OnlineTrainer``), and ``DataReaderParams(
source="criteo", path=...)`` reads a Criteo TSV.

**Model parallelism.** ``Solver`` carries the mesh intent and ``fit()``
honors it end to end, one process a device: under ``torchrun
--nproc-per-node N`` (or any initialized ``torch.distributed`` process
group) ``mesh_shape=(r, c)`` lays the ranks out as a ``("data", "model")``
mesh (``launch.mesh.make_test_mesh``; a shape larger than the group raises
naming the fix), the embeddings shard over it per the placement planner
while the dense net stays data-parallel, and the step runs under
``mode="gspmd"`` (f32 gradient all-reduce) or ``mode="manual"`` (the
all-reduce in ``grad_allreduce_dtype``, bf16 compressing it). ``comm``
picks the embedding exchange per collection: ``"allgather_rs"``,
``"all_to_all"`` or ``"auto"`` (all-to-all only for groups of large
one-hot tables, at least ``a2a_threshold`` rows). Every rank reads the
same global batches and trains on its data-parallel block; rank 0 writes
checkpoints and bundles, which hold mesh-independent logical arrays, so
``save()`` on one mesh and ``load()`` on another just works. Without a
process group (or with one rank and no ``mesh_shape``) the model trains on
one device with no mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import (
    EmbeddingTableConfig, ETCParams, RecsysConfig, SparseGroupConfig,
    TrainConfig, recsys_config_hash,
)
from repro_torch.device import DeviceLike
from repro_torch.models.recsys.dense_graph import (
    RESERVED_NAMES, GraphError, compile_layers, graph_spec, spec_from_layer,
    spec_layers,
)
from repro_torch.launch import mesh as meshlib

GRAPH_FORMAT = "repro-graph-v1"


@dataclasses.dataclass
class Solver:
    """Run-level knobs (HugeCTR's ``CreateSolver``); the JAX package's
    field set, so ``graph.json`` round-trips between the packages.
    ``mesh_shape`` is checked against the ranks of the process group (one
    device without one)."""
    batch_size: int = 256
    lr: float = 1e-3
    optimizer: str = "adamw"
    sparse_optimizer: str = "rowwise_adagrad"
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    grad_allreduce_dtype: str = "f32"
    mixed_precision: bool = True
    mode: str = "gspmd"
    mesh_shape: Optional[Tuple[int, ...]] = None
    comm: str = "auto"
    a2a_threshold: int = 65536
    ckpt_interval: int = 50
    seed: int = 0
    #: ETC-staged training (HugeCTR's Embedding Training Cache): set to
    #: ``ETCParams(cache_rows=..., ps="staged"|"cached", passes=N)`` and
    #: ``fit()`` trains through a fixed-capacity device row cache backed
    #: by a parameter server instead of full in-device tables —
    #: ``cache_rows`` bounds device rows per table, ``ps`` picks the
    #: durable tier ("cached" needs ``ps_root``, survives restarts and
    #: fsyncs on flush), ``passes`` splits the run into keyset-staged
    #: passes whose boundaries flush the cache and (via
    #: ``repro_torch.online``) publish versioned updates to live servers.
    #: None (default) keeps the in-memory trainer.
    etc: Optional[ETCParams] = None

    def __post_init__(self):
        if self.etc is not None and not isinstance(self.etc, ETCParams):
            if not isinstance(self.etc, dict):
                raise GraphError(
                    f"Solver.etc must be an ETCParams (or its dict "
                    f"form), got {type(self.etc).__name__}")
            try:                   # JSON round-trip: Solver(**d["solver"])
                self.etc = ETCParams(**self.etc)
            except (TypeError, ValueError) as e:
                raise GraphError(f"Solver.etc: {e}")
        if self.mode not in ("gspmd", "manual"):
            raise GraphError(
                f"Solver.mode must be 'gspmd' or 'manual', got "
                f"{self.mode!r}")
        if self.comm not in ("auto", "allgather_rs", "all_to_all"):
            raise GraphError(
                f"Solver.comm must be 'auto', 'allgather_rs' or "
                f"'all_to_all', got {self.comm!r}")
        if self.mesh_shape is not None:
            shape = tuple(self.mesh_shape)
            if not shape or any(not isinstance(s, int) or
                                isinstance(s, bool) or s <= 0
                                for s in shape):
                raise GraphError(
                    f"Solver.mesh_shape must be a non-empty tuple of "
                    f"positive ints, got {self.mesh_shape!r}")
            want = int(np.prod(shape))
            visible = meshlib.world_size()
            if want > visible:
                raise GraphError(
                    f"Solver.mesh_shape={shape} asks for {want} devices "
                    f"but only {visible} are visible (the ranks of the "
                    "process group); shrink the mesh or "
                    + meshlib.launch_hint(want))
            self.mesh_shape = shape

    def to_train_config(self) -> TrainConfig:
        return TrainConfig(
            learning_rate=self.lr, dense_optimizer=self.optimizer,
            sparse_optimizer=self.sparse_optimizer,
            weight_decay=self.weight_decay, grad_clip=self.grad_clip,
            mixed_precision=self.mixed_precision,
            grad_allreduce_dtype=self.grad_allreduce_dtype)


def CreateSolver(**kwargs) -> Solver:  # noqa: N802 — HugeCTR spelling
    return Solver(**kwargs)


@dataclasses.dataclass
class DataReaderParams:
    """Input source + feature spec (carried in graph.json)."""
    source: str = "synthetic"
    num_dense_features: int = 13
    path: Optional[str] = None
    seed: int = 0
    zipf_a: float = 1.1

    def __post_init__(self):
        if self.source not in ("synthetic", "criteo"):
            raise GraphError(f"unknown reader source {self.source!r}")


@dataclasses.dataclass
class Input:
    """Declares the named input tensors every other layer wires to."""
    dense_dim: int
    dense_name: str = "dense"
    sparse_name: str = "cat"
    label_name: str = "label"


@dataclasses.dataclass
class SparseEmbedding:
    """One embedding group: tables sharing dim / combiner / strategy."""
    vocab_sizes: Sequence[int]
    dim: int
    top_name: str = "emb"
    bottom_name: str = "cat"
    hotness: Union[int, Sequence[int]] = 1
    combiner: str = "sum"
    strategy: str = "auto"
    hot_fraction: float = 0.05
    table_names: Optional[Sequence[str]] = None

    def __post_init__(self):
        self.vocab_sizes = tuple(int(v) for v in self.vocab_sizes)
        if not isinstance(self.hotness, int):
            self.hotness = tuple(int(h) for h in self.hotness)
        if self.table_names is not None:
            self.table_names = tuple(self.table_names)
            if len(self.table_names) != len(self.vocab_sizes):
                raise GraphError(
                    f"{len(self.table_names)} table_names for "
                    f"{len(self.vocab_sizes)} vocab_sizes")

    def to_tables(self, *, default_prefix: str = ""
                  ) -> Tuple[EmbeddingTableConfig, ...]:
        """The group's tables; unnamed tables are
        ``<default_prefix>f<i>``."""
        names = self.table_names or tuple(
            f"{default_prefix}f{i}" for i in range(len(self.vocab_sizes)))
        hot = self.hotness if not isinstance(self.hotness, int) else \
            (self.hotness,) * len(self.vocab_sizes)
        return tuple(
            EmbeddingTableConfig(names[i], v, self.dim, hotness=hot[i],
                                 combiner=self.combiner,
                                 strategy=self.strategy,
                                 hot_fraction=self.hot_fraction)
            for i, v in enumerate(self.vocab_sizes))


DENSE_LAYER_TYPES = ("mlp", "cross", "dot_interaction", "fm", "concat",
                     "sigmoid", "add", "multiply", "relu", "slice",
                     "reduce_sum")


@dataclasses.dataclass
class DenseLayer:
    """One named dense layer, wired by tensor names (the JAX package's
    vocabulary): ``mlp`` over its implicitly concatenated bottoms,
    ``cross``, ``dot_interaction``, ``fm`` over ``[dense, wide, emb]``,
    ``concat``, elementwise ``add`` / ``multiply`` / ``relu``, ``slice``
    ``[start:stop]`` of a feature block, ``reduce_sum`` to a logit column,
    and the terminal ``sigmoid`` over summed logits."""
    type: str
    bottom_names: Sequence[str]
    top_names: Sequence[str]
    units: Sequence[int] = ()
    num_layers: int = 0
    final_activation: bool = False
    start: int = 0
    stop: int = 0

    def __post_init__(self):
        if self.type not in DENSE_LAYER_TYPES:
            raise GraphError(
                f"unknown DenseLayer type {self.type!r}; expected one "
                f"of {DENSE_LAYER_TYPES}")
        self.bottom_names = tuple(self.bottom_names)
        self.top_names = tuple(self.top_names)
        self.units = tuple(int(u) for u in self.units)
        if len(self.top_names) != 1:
            raise GraphError(
                f"DenseLayer({self.type}) must produce exactly one "
                f"output, got top_names={self.top_names}")

    @property
    def top(self) -> str:
        return self.top_names[0]


# ---------------------------------------------------------------------------
# Lowering: layer graph -> RecsysConfig (recipe recognition, else "graph")
# ---------------------------------------------------------------------------

def _check_embeddings(inp: Input, embs: List[SparseEmbedding]) -> None:
    produced = {inp.dense_name}
    for e in embs:
        if e.bottom_name != inp.sparse_name:
            raise GraphError(
                f"SparseEmbedding {e.top_name!r} reads "
                f"{e.bottom_name!r} but the Input's sparse tensor is "
                f"{inp.sparse_name!r}")
        if e.top_name in produced:
            raise GraphError(f"duplicate tensor name {e.top_name!r}")
        if e.top_name in RESERVED_NAMES or \
                e.top_name.startswith("embedding@"):
            raise GraphError(
                f"SparseEmbedding top_name {e.top_name!r} is reserved "
                "for the embedding parameter groups")
        produced.add(e.top_name)


def _split_embeddings(embs: List[SparseEmbedding]
                      ) -> Tuple[SparseEmbedding, Optional[SparseEmbedding],
                                 List[SparseEmbedding]]:
    """``(deep, wide, extras)``: exactly two groups where one is the dim-1
    exact twin of the other (same vocab sizes, ``combiner="sum"``) are the
    deep group and its wide branch (WDL, DeepFM); otherwise the first
    declared group is the primary one and every further group an extra
    with its own dim, collection and HPS."""
    if len(embs) == 1:
        return embs[0], None, []
    if len(embs) == 2:
        wides = [e for e in embs if e.dim == 1]
        if len(wides) == 1:
            wide = wides[0]
            deep = next(e for e in embs if e is not wide)
            if wide.vocab_sizes == deep.vocab_sizes and \
                    wide.combiner == "sum":
                return deep, wide, []
    return embs[0], None, list(embs[1:])


def _find(layers: List[DenseLayer], type_: str,
          bottoms: Optional[Tuple[str, ...]] = None) -> List[DenseLayer]:
    return [l for l in layers if l.type == type_ and
            (bottoms is None or tuple(l.bottom_names) == tuple(bottoms))]


def _take_sigmoid(layers: List[DenseLayer], logits: Tuple[str, ...],
                  used: List[DenseLayer], *, required: bool) -> bool:
    sigs = _find(layers, "sigmoid")
    if len(sigs) > 1:
        return False
    if not sigs:
        return not required
    if len(sigs[0].bottom_names) != len(logits) or \
            set(sigs[0].bottom_names) != set(logits):
        return False
    used.append(sigs[0])
    return True


def _classify_dlrm(name, inp, deep, layers):
    """The reference's DLRM recognition: the canonical config, or None."""
    inters = _find(layers, "dot_interaction")
    if len(inters) != 1:
        return None
    inter = inters[0]
    if len(inter.bottom_names) != 2 or \
            inter.bottom_names[1] != deep.top_name:
        return None
    bots = [l for l in layers if l.top == inter.bottom_names[0]]
    if len(bots) != 1:
        return None
    bot = bots[0]
    if bot.type != "mlp" or tuple(bot.bottom_names) != (inp.dense_name,) \
            or not bot.final_activation or not bot.units \
            or bot.units[-1] != deep.dim:
        return None
    used = [bot, inter]
    top_bottoms = (bot.top, inter.top)
    cats = _find(layers, "concat", top_bottoms)
    if cats:
        if len(cats) != 1:
            return None
        used.append(cats[0])
        top_bottoms = (cats[0].top,)
    tops = [l for l in layers if l.type == "mlp" and l is not bot]
    if len(tops) != 1:
        return None
    top = tops[0]
    if tuple(top.bottom_names) != top_bottoms or not top.units or \
            top.units[-1] != 1 or top.final_activation:
        return None
    used.append(top)
    if not _take_sigmoid(layers, (top.top,), used, required=False):
        return None
    if len(used) != len(layers):
        return None
    return RecsysConfig(
        name=name, model="dlrm", tables=deep.to_tables(),
        num_dense_features=inp.dense_dim, bottom_mlp=bot.units,
        top_mlp=top.units, embedding_dim=deep.dim)


def _classify_dcn(name, inp, deep, layers):
    """The reference's DCN recognition: concat(dense, emb) into an
    optional cross net and a deep MLP, both concatenated into a 1-unit
    combine head."""
    flats = _find(layers, "concat", (inp.dense_name, deep.top_name))
    if len(flats) != 1:
        return None
    flat = flats[0]
    used = [flat]
    crosses = _find(layers, "cross")
    if len(crosses) > 1:
        return None
    crossed = flat.top
    cross = crosses[0] if crosses else None
    if cross is not None:
        if tuple(cross.bottom_names) != (flat.top,):
            return None
        crossed = cross.top
        used.append(cross)
    mlps = [l for l in layers if l.type == "mlp"]
    deeps = [l for l in mlps if tuple(l.bottom_names) == (flat.top,)]
    if len(deeps) != 1:
        return None
    deep_mlp = deeps[0]
    if deep_mlp.final_activation or not deep_mlp.units:
        return None
    used.append(deep_mlp)
    boths = _find(layers, "concat", (crossed, deep_mlp.top))
    if len(boths) != 1:
        return None
    used.append(boths[0])
    combines = [l for l in mlps
                if tuple(l.bottom_names) == (boths[0].top,)]
    if len(combines) != 1:
        return None
    combine = combines[0]
    if combine.units != (1,) or combine.final_activation:
        return None
    used.append(combine)
    if not _take_sigmoid(layers, (combine.top,), used, required=False):
        return None
    if len(used) != len(layers):
        return None
    return RecsysConfig(
        name=name, model="dcn", tables=deep.to_tables(),
        num_dense_features=inp.dense_dim, bottom_mlp=(),
        top_mlp=deep_mlp.units, embedding_dim=deep.dim,
        num_cross_layers=cross.num_layers if cross is not None else 0)


def _classify_flat_deep(inp, deep, layers):
    """The concat + 1-logit deep tower that DeepFM and WDL share."""
    flats = _find(layers, "concat", (inp.dense_name, deep.top_name))
    if len(flats) != 1:
        return None
    flat = flats[0]
    deeps = [l for l in layers if l.type == "mlp"
             and tuple(l.bottom_names) == (flat.top,)]
    if len(deeps) != 1:
        return None
    deep_mlp = deeps[0]
    if deep_mlp.final_activation or not deep_mlp.units or \
            deep_mlp.units[-1] != 1:
        return None
    return flat, deep_mlp


def _classify_deepfm(name, inp, deep, wide, layers):
    pair = _classify_flat_deep(inp, deep, layers)
    if pair is None:
        return None
    flat, deep_mlp = pair
    fms = _find(layers, "fm")
    if len(fms) != 1:
        return None
    fm = fms[0]
    if len(fm.bottom_names) != 3 or set(fm.bottom_names) != \
            {inp.dense_name, wide.top_name, deep.top_name}:
        return None
    used = [flat, deep_mlp, fm]
    if not _take_sigmoid(layers, (fm.top, deep_mlp.top), used,
                         required=True):
        return None
    if len(used) != len(layers):
        return None
    return RecsysConfig(
        name=name, model="deepfm", tables=deep.to_tables(),
        num_dense_features=inp.dense_dim, bottom_mlp=(),
        top_mlp=deep_mlp.units[:-1], embedding_dim=deep.dim)


def _classify_wdl(name, inp, deep, wide, layers):
    """WDL: the deep tower plus a 1-unit head over ``[dense, wide]``, which
    lowers to the first-order term (the wide branch pooled with fixed
    weight 1, as the paper's recipe)."""
    pair = _classify_flat_deep(inp, deep, layers)
    if pair is None:
        return None
    flat, deep_mlp = pair
    heads = [l for l in layers if l.type == "mlp"
             and set(l.bottom_names) == {inp.dense_name, wide.top_name}]
    if len(heads) != 1:
        return None
    head = heads[0]
    if head.units != (1,) or head.final_activation:
        return None
    used = [flat, deep_mlp, head]
    if not _take_sigmoid(layers, (head.top, deep_mlp.top), used,
                         required=True):
        return None
    if len(used) != len(layers):
        return None
    return RecsysConfig(
        name=name, model="wdl", tables=deep.to_tables(),
        num_dense_features=inp.dense_dim, bottom_mlp=(),
        top_mlp=deep_mlp.units[:-1], embedding_dim=deep.dim)


def _classify_canonical(name, inp, deep, wide, layers):
    """The canonical config of one of the four paper recipes, or None."""
    types = {l.type for l in layers}
    if types - {"mlp", "cross", "dot_interaction", "fm", "concat",
                "sigmoid"}:
        return None
    if "dot_interaction" in types:
        if wide is not None:
            return None
        return _classify_dlrm(name, inp, deep, layers)
    if "fm" in types:
        if wide is None:
            return None
        return _classify_deepfm(name, inp, deep, wide, layers)
    if wide is not None:
        return _classify_wdl(name, inp, deep, wide, layers)
    return _classify_dcn(name, inp, deep, layers)


def lower_graph(name: str, inp: Optional[Input],
                embs: List[SparseEmbedding],
                layers: List[DenseLayer]) -> RecsysConfig:
    """Validate the layer graph (wiring, shapes, one terminal) by
    compiling it, then lower it onto the canonical config of one of the
    four paper recipes when it is one, else onto a ``model="graph"``
    config with the DAG embedded. :class:`GraphError` names the offending
    layer or tensor of an invalid graph, and a table name used by two
    groups."""
    if inp is None:
        raise GraphError("the graph needs an Input layer")
    if not embs:
        raise GraphError("the graph needs at least one SparseEmbedding")
    _check_embeddings(inp, embs)
    deep, wide, extras = _split_embeddings(embs)
    specs = [spec_from_layer(l) for l in layers]
    compile_layers(
        specs, dense_name=inp.dense_name, num_dense=inp.dense_dim,
        emb_name=deep.top_name, num_tables=len(deep.vocab_sizes),
        emb_dim=deep.dim,
        wide_name=wide.top_name if wide is not None else None,
        extra_embs={e.top_name: (len(e.vocab_sizes), e.dim)
                    for e in extras})
    if not extras:
        cfg = _classify_canonical(name, inp, deep, wide, layers)
        if cfg is not None:
            return cfg
    extra_groups = tuple(
        SparseGroupConfig(
            name=e.top_name,
            tables=e.to_tables(default_prefix=f"{e.top_name}_"),
            dim=e.dim)
        for e in extras)
    seen = set()
    for t in deep.to_tables() + tuple(t for g in extra_groups
                                      for t in g.tables):
        if t.name in seen:
            raise GraphError(
                f"table name {t.name!r} is used by more than one "
                "SparseEmbedding group; table names must be globally "
                "unique (set table_names explicitly)")
        seen.add(t.name)
    return RecsysConfig(
        name=name, model="graph", tables=deep.to_tables(),
        num_dense_features=inp.dense_dim, bottom_mlp=(), top_mlp=(),
        embedding_dim=deep.dim,
        dense_graph=graph_spec(
            inp.dense_name, deep.top_name,
            wide.top_name if wide is not None else None, specs,
            extras=tuple(e.top_name for e in extras)),
        wide_branch=wide is not None,
        extra_groups=extra_groups)


def _validate_mesh_fit(cfg: RecsysConfig, mesh, batch_size: int) -> None:
    """Up-front mesh / batch / table divisibility validation (the
    reference's): a :class:`GraphError` at ``compile()`` naming the
    offending axis or table group."""
    from repro_torch.core.embedding.planner import resolve_strategies
    from repro_torch.models.recsys.model import has_wide, wide_tables
    shape = meshlib.mesh_shape(mesh)
    dp = meshlib.dp_axes(mesh)
    n_dp = meshlib.axis_size(mesh, dp)
    n_dev = meshlib.mesh_size(mesh)
    if batch_size % max(1, n_dp) != 0:
        raise GraphError(
            f"batch_size={batch_size} is not divisible by the data-"
            f"parallel device count {n_dp} (mesh axes {dp} of mesh "
            f"shape {shape}); batches shard over the data "
            "axes, so pick a batch size the data extent divides")
    groups = [("emb", cfg.tables)]
    if has_wide(cfg):
        groups.append(("wide", wide_tables(cfg)))
    for g in cfg.extra_groups:
        groups.append((g.name, g.tables))
    mc = meshlib.mesh_config_for(mesh)
    for gname, tabs in groups:
        resolved = resolve_strategies(tabs, mc, batch_size)
        loc = [t for t in resolved if t.strategy == "localized"]
        if loc and len(loc) % n_dev != 0:
            raise GraphError(
                f"embedding group {gname!r}: {len(loc)} localized "
                f"table(s) {[t.name for t in loc]} cannot spread evenly "
                f"over {n_dev} devices; localized placement needs the "
                "table count divisible by the device count")


class Model:
    """A declarative model graph: ``add`` layers, lower with
    :meth:`to_recsys_config`, round-trip through ``graph.json``; then
    ``compile`` / ``fit`` / ``predict`` / ``save`` / ``load`` / ``deploy``
    drive the lowered model, on one device or on a mesh (one rank a
    device; every rank of it makes the same calls)."""

    def __init__(self, solver: Optional[Solver] = None,
                 reader: Optional[DataReaderParams] = None, *,
                 name: str = "model", mesh=None):
        self.solver = solver or Solver()
        self.reader = reader
        self.name = name
        self._mesh_override = mesh
        self.mesh = None
        self._input: Optional[Input] = None
        self._embeddings: List[SparseEmbedding] = []
        self._dense_layers: List[DenseLayer] = []
        self.cfg: Optional[RecsysConfig] = None
        self.device: Optional[torch.device] = None
        self._model = None            # lowered RecsysModel
        self._tcfg: Optional[TrainConfig] = None
        self._params = None
        self._opt_state = None
        self._online = None           # OnlineTrainer after an ETC fit()
        self.stragglers = 0

    def add(self, layer) -> "Model":
        if isinstance(layer, Input):
            if self._input is not None:
                raise GraphError("the graph already has an Input layer")
            self._input = layer
        elif isinstance(layer, SparseEmbedding):
            self._embeddings.append(layer)
        elif isinstance(layer, DenseLayer):
            self._dense_layers.append(layer)
        else:
            raise GraphError(
                f"model.add() takes Input, SparseEmbedding or "
                f"DenseLayer, got {type(layer).__name__}")
        return self

    def to_recsys_config(self) -> RecsysConfig:
        """The lowering pass (pure — no devices touched)."""
        return lower_graph(self.name, self._input, self._embeddings,
                           self._dense_layers)

    # -- compile ----------------------------------------------------------------

    def compile(self, *, device: DeviceLike = None,
                use_kernels: bool = True, mesh=None) -> "Model":
        """Lower the graph and build the model on ``device`` (``cuda``
        unless ``"cpu"`` is given; raises without a card), or on ``mesh``
        (given here, to the constructor, or made from
        ``Solver.mesh_shape``), each rank on its own device.
        ``use_kernels=False`` runs the plain versions of the kernels."""
        from repro_torch.models.recsys.model import RecsysModel
        self.cfg = self.to_recsys_config()
        if self.reader is not None and \
                self.reader.num_dense_features != self._input.dense_dim:
            raise GraphError(
                f"reader num_dense_features="
                f"{self.reader.num_dense_features} != Input dense_dim="
                f"{self._input.dense_dim}")
        self._tcfg = self.solver.to_train_config()
        self.batch_size = self.solver.batch_size
        self.mesh = mesh or self._mesh_override \
            or meshlib.auto_mesh(self.solver.mesh_shape)
        if self.mesh is not None:
            _validate_mesh_fit(self.cfg, self.mesh, self.batch_size)
        self._model = RecsysModel(
            self.cfg, device=device, use_kernels=use_kernels,
            global_batch=self.batch_size, comm=self.solver.comm,
            mesh=self.mesh, a2a_threshold=self.solver.a2a_threshold)
        self.device = self._model.device
        return self

    @property
    def model(self):
        """The lowered RecsysModel (compile() first)."""
        return self._model

    @property
    def params(self):
        return self._params

    def _require_compiled(self):
        if self._model is None:
            self.compile()

    # -- train --------------------------------------------------------------------

    def _reader_data_fn(self) -> Callable[[int], Dict]:
        r = self.reader or DataReaderParams(
            num_dense_features=self.cfg.num_dense_features)
        if r.source == "synthetic":
            from repro_torch.data.synthetic import SyntheticCTR
            return SyntheticCTR(self.cfg, self.batch_size, seed=r.seed,
                                zipf_a=r.zipf_a).batch
        from repro_torch.data import criteo
        if r.path is None:
            raise GraphError("DataReaderParams(source='criteo') needs "
                             "a path")
        # seekable batch(step): criteo runs get the same deterministic
        # replay contract as the synthetic reader (the ETC's keyset
        # staging replays the reader by step)
        return criteo.CriteoReader(r.path, self.cfg, self.batch_size).batch

    def fit(self, data_fn: Optional[Callable[[int], Dict]] = None,
            steps: int = 100, *, ckpt_dir: Optional[str] = None,
            log_every: int = 0, seed: Optional[int] = None,
            failure_injector: Optional[Callable[[int], None]] = None
            ) -> List[Dict]:
        """Train; ``data_fn(step) -> {"dense", "cat", "label"}`` host
        batches (defaults to the reader's source). Resumes from a newer
        checkpoint in ``ckpt_dir`` if present, else from weights already
        held (e.g. after :meth:`load`)."""
        self._require_compiled()
        if data_fn is None:
            data_fn = self._reader_data_fn()
        if self.solver.etc is not None:
            return self._fit_etc(data_fn, steps, ckpt_dir=ckpt_dir,
                                 log_every=log_every, seed=seed,
                                 failure_injector=failure_injector)
        from repro_torch.train.trainer import Trainer
        trainer = Trainer(self._model, self._tcfg, data_fn,
                          ckpt_dir=ckpt_dir,
                          ckpt_interval=self.solver.ckpt_interval,
                          mode=self.solver.mode)
        trainer.failure_injector = failure_injector
        init = (self._params, self._opt_state) \
            if self._params is not None else None
        out = trainer.train(
            steps, seed=self.solver.seed if seed is None else seed,
            log_every=log_every, initial_state=init)
        self._params = out["params"]
        self._opt_state = out["opt_state"]
        self.stragglers = out["stragglers"]
        return out["history"]

    def _fit_etc(self, data_fn, steps, *, ckpt_dir, log_every, seed,
                 failure_injector, publisher=None) -> List[Dict]:
        """``fit()`` through the Embedding Training Cache (Solver.etc):
        keyset-staged passes over a fixed-capacity device cache, the
        parameter server as the durable tier, and — when ``publisher``
        is attached — one versioned online update per pass boundary.
        After training the PS contents are imported back into
        ``params``, so predict/save/deploy see a normal model."""
        if ckpt_dir is not None:
            raise GraphError(
                "ETC-staged fit() does not take ckpt_dir: durability "
                "goes through the parameter server — use "
                "ETCParams(ps='cached', ps_root=...) instead")
        if failure_injector is not None:
            raise GraphError(
                "ETC-staged fit() does not support failure_injector")
        from repro_torch.online.trainer import OnlineTrainer
        ot = OnlineTrainer(
            self, self.solver.etc, publisher=publisher,
            seed=self.solver.seed if seed is None else seed)
        history = ot.fit(data_fn, steps, log_every=log_every)
        self._params = ot.export_params()
        self._opt_state = None
        self._online = ot
        return history

    # -- inference ------------------------------------------------------------------

    def predict(self, batch: Dict) -> np.ndarray:
        """Probabilities ``[B]`` for a host batch (``dense``, ``cat``); wide
        models look their wide twins up in the same ``cat`` columns. On a
        mesh every rank passes the same batch, predicts its data-parallel
        block and gets the whole ``[B]``."""
        if self._params is None:
            raise RuntimeError("fit() or load() before predict()")
        from repro_torch.core.embedding.strategies import all_gather
        from repro_torch.train.trainer import put_batch
        dev = put_batch({k: v for k, v in batch.items()
                         if k in ("dense", "cat")}, self.device, self.mesh)
        with torch.no_grad():
            prob = torch.sigmoid(self._model.apply(self._params, dev))
            if self.mesh is not None:
                prob = all_gather(prob, meshlib.axis_group(
                    self.mesh, meshlib.dp_axes(self.mesh)))
            return prob.cpu().numpy()

    # -- introspection ----------------------------------------------------------------

    def summary(self) -> str:
        """The graph, a line a layer (the reference's text); printed and
        returned."""
        cfg = self.to_recsys_config()
        lines = [f'Model "{self.name}" -> {cfg.model} '
                 f'({cfg.num_tables} tables, '
                 f'{cfg.total_embedding_params / 1e6:.2f}M embedding '
                 f'params)']
        i = self._input
        lines.append(f"  Input              {i.dense_name}[{i.dense_dim}]"
                     f" {i.sparse_name} {i.label_name}")
        for e in self._embeddings:
            hot = e.hotness if isinstance(e.hotness, int) \
                else f"{min(e.hotness)}..{max(e.hotness)}"
            lines.append(
                f"  SparseEmbedding    {e.bottom_name} -> {e.top_name}"
                f"  T={len(e.vocab_sizes)} D={e.dim} hot={hot} "
                f"combiner={e.combiner} strategy={e.strategy}")
        for l in self._dense_layers:
            extra = ""
            if l.type == "mlp":
                extra = f"  units={l.units}"
            elif l.type == "cross":
                extra = f"  num_layers={l.num_layers}"
            lines.append(
                f"  DenseLayer {l.type:<15} "
                f"{list(l.bottom_names)} -> {l.top}{extra}")
        out = "\n".join(lines)
        print(out)
        return out

    # -- persistence ------------------------------------------------------------------

    def _lead(self) -> bool:
        """Whether this process writes (rank 0 of the mesh; always
        without one)."""
        return self.mesh is None or meshlib.axis_index(
            self.mesh, meshlib.all_axes(self.mesh)) == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            torch.distributed.barrier(group=meshlib.axis_group(
                self.mesh, meshlib.all_axes(self.mesh)))

    def save(self, directory: str, step: int = 0) -> str:
        """Write the graph (graph.json) and a logical-layout checkpoint:
        everything :meth:`load` (of either package) needs. On a mesh every
        rank gathers and rank 0 writes."""
        if self._params is None:
            raise RuntimeError("nothing to save: fit() or load() first")
        from repro_torch.models.recsys.model import export_logical_params
        from repro_torch.train import checkpoint as ck
        tree = {"params": export_logical_params(self._model, self._params)}
        if self._lead():
            os.makedirs(directory, exist_ok=True)
            self.graph_to_json(os.path.join(directory, "graph.json"))
            ck.save(directory, step, tree)
        self._barrier()
        return directory

    @classmethod
    def load(cls, directory: str, *, device: DeviceLike = None,
             mesh=None) -> "Model":
        """Rebuild a model from :meth:`save` output alone: graph JSON and
        the newest checkpoint, onto ``device`` or any ``mesh`` (the
        checkpoint is mesh-independent). ``predict()`` works at once;
        ``fit()`` continues from the loaded weights."""
        from repro_torch.models.recsys.model import import_logical_params
        from repro_torch.train import checkpoint as ck
        m = cls.from_json(os.path.join(directory, "graph.json"))
        m.compile(device=device, mesh=mesh)
        step = ck.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        tree, _ = ck.load_tree(directory, step, device=m.device)
        m._params = import_logical_params(m._model, tree["params"])
        return m

    # -- deployment -------------------------------------------------------------------

    def dense_params(self) -> Dict:
        from repro_torch.train.train_step import split_params
        return split_params(self._params)[1]

    def _write_bundle_member(self, pdb, bundle_dir: str, sub: str, *,
                             cache_capacity: int, cache_shards: int,
                             refresh_budget: int, max_batch: int,
                             payload_dtype: str = "f32", tables=None):
        """Export THIS model into a deployment bundle: every table (the
        ``*_wide`` twins of a wide model and every extra group's tables
        included) into the (possibly shared) PDB, ``graph.json`` and
        ``dense.npz`` under ``bundle_dir/sub``; returns the relocatable
        HPSConfig, its paths relative to ``bundle_dir``. ``tables`` are
        the logical tables when already gathered."""
        from repro_torch.serve.server import (trained_tables,
                                              write_bundle_member)
        if tables is None:
            tables = trained_tables(self._model, self._params)
        return write_bundle_member(
            pdb, bundle_dir, sub, self, self.dense_params(), tables,
            cache_capacity=cache_capacity, cache_shards=cache_shards,
            refresh_budget=refresh_budget, max_batch=max_batch,
            payload_dtype=payload_dtype)

    def _build_server(self, pdb, hcfg, *, vdb=None, bus=None):
        """This model's HPSes + InferenceServer over storage that holds
        its tables (``serve.server.build_server``), on a frozen copy of
        the dense weights: a later ``fit()`` does not move a deployed
        server's."""
        from repro_torch.serve.server import build_server
        from repro_torch.tree import tree_map
        dense = tree_map(lambda t: t.detach().clone(), self.dense_params())
        return build_server(self._model, pdb, hcfg, dense, vdb=vdb,
                            bus=bus)

    def deploy(self, directory: str, *, cache_capacity: int = 4096,
               cache_shards: int = 1, refresh_budget: int = 512,
               max_batch: int = 1024, payload_dtype: str = "f32",
               vdb=None, bus=None):
        """Write the serving bundle (``pdb/`` with every table: the
        ``*_wide`` twins of a wide model and every extra group's tables
        included; ``graph.json``, ``dense.npz``, ``ps.json`` with ``wide``
        set for a wide model, the L1 striping ``cache_shards`` and the
        ``refresh_budget``) and return an ``InferenceServer`` over it on
        this model's device, one HPS per table set, over the given
        VolatileDB and message bus. Either package's
        ``build_server_from_config`` serves the bundle; to serve several
        models from one bundle, see :func:`deploy_ensemble`. On a mesh
        every rank gathers the tables, rank 0 writes the bundle and gets
        the server (one device serves it), the others None."""
        if self._params is None:
            raise RuntimeError("fit() or load() before deploy()")
        from repro_torch.configs.base import hps_config_to_dict
        from repro_torch.core.hps.persistent_db import PersistentDB
        if self.mesh is not None:
            from repro_torch.serve.server import trained_tables
            tables = trained_tables(self._model, self._params)
            server = None
            if self._lead():
                os.makedirs(directory, exist_ok=True)
                pdb = PersistentDB(os.path.join(directory, "pdb"))
                hcfg = self._write_bundle_member(
                    pdb, directory, "", cache_capacity=cache_capacity,
                    cache_shards=cache_shards,
                    refresh_budget=refresh_budget, max_batch=max_batch,
                    payload_dtype=payload_dtype, tables=tables)
                with open(os.path.join(directory, "ps.json"), "w") as f:
                    json.dump(hps_config_to_dict(hcfg), f, indent=1)
                server = self._build_server(pdb, hcfg, vdb=vdb, bus=bus)
            self._barrier()
            return server
        os.makedirs(directory, exist_ok=True)
        pdb = PersistentDB(os.path.join(directory, "pdb"))
        hcfg = self._write_bundle_member(
            pdb, directory, "", cache_capacity=cache_capacity,
            cache_shards=cache_shards, refresh_budget=refresh_budget,
            max_batch=max_batch, payload_dtype=payload_dtype)
        with open(os.path.join(directory, "ps.json"), "w") as f:
            json.dump(hps_config_to_dict(hcfg), f, indent=1)
        return self._build_server(pdb, hcfg, vdb=vdb, bus=bus)

    def graph_dict(self) -> Dict:
        layers: List[Dict] = []
        if self._input is not None:
            layers.append({"kind": "input",
                           **dataclasses.asdict(self._input)})
        for e in self._embeddings:
            layers.append({"kind": "sparse_embedding",
                           **dataclasses.asdict(e)})
        for l in self._dense_layers:
            layers.append({"kind": "dense", **dataclasses.asdict(l)})
        return {
            "format": GRAPH_FORMAT,
            "name": self.name,
            "solver": dataclasses.asdict(self.solver),
            "reader": dataclasses.asdict(self.reader)
            if self.reader is not None else None,
            "layers": layers,
            "config_hash": recsys_config_hash(self.to_recsys_config()),
        }

    def graph_to_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.graph_dict(), f, indent=1)
        return path

    @classmethod
    def from_json(cls, path: str, *, mesh=None) -> "Model":
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != GRAPH_FORMAT:
            raise GraphError(
                f"{path}: unknown graph format {d.get('format')!r}")
        m = cls(Solver(**d["solver"]),
                DataReaderParams(**d["reader"])
                if d.get("reader") else None,
                name=d["name"], mesh=mesh)
        kinds = {"input": Input, "sparse_embedding": SparseEmbedding,
                 "dense": DenseLayer}
        for ld in d["layers"]:
            ld = dict(ld)
            kind = ld.pop("kind")
            if kind not in kinds:
                raise GraphError(f"{path}: unknown layer kind {kind!r}")
            m.add(kinds[kind](**ld))
        got = recsys_config_hash(m.to_recsys_config())
        if d.get("config_hash") and got != d["config_hash"]:
            raise GraphError(
                f"{path}: graph lowers to config hash {got} but the "
                f"file claims {d['config_hash']}")
        return m


def _group(tables: Sequence[EmbeddingTableConfig], dim: int,
           top_name: str) -> SparseEmbedding:
    """The ``SparseEmbedding`` that declares ``tables`` (named, with
    their hotness; combiner, strategy and hot fraction of the first)."""
    t0 = tables[0]
    hot = [t.hotness for t in tables]
    return SparseEmbedding(
        vocab_sizes=[t.vocab_size for t in tables], dim=dim,
        top_name=top_name, hotness=hot[0] if len(set(hot)) == 1 else hot,
        combiner=t0.combiner, strategy=t0.strategy,
        hot_fraction=t0.hot_fraction, table_names=[t.name for t in tables])


def _recipe_model(cfg: RecsysConfig, solver: Optional[Solver],
                  reader: Optional[DataReaderParams], *,
                  emb_name: str = "emb", wide_name: Optional[str] = None,
                  dense_name: str = "dense") -> Model:
    """A Model with the Input and the deep group of ``cfg`` (tables named
    by ``cfg``, tensor ``emb_name``) and, with ``wide_name``, their dim-1
    twin group."""
    m = Model(solver or Solver(),
              reader or DataReaderParams(
                  num_dense_features=cfg.num_dense_features),
              name=cfg.name)
    m.add(Input(dense_dim=cfg.num_dense_features, dense_name=dense_name))
    deep = _group(cfg.tables, cfg.embedding_dim, emb_name)
    m.add(deep)
    if wide_name:
        m.add(SparseEmbedding(
            vocab_sizes=deep.vocab_sizes, dim=1, top_name=wide_name,
            hotness=deep.hotness))
    return m


def _lowers_back(m: Model, cfg: RecsysConfig) -> Model:
    if m.to_recsys_config() != cfg:
        raise ValueError(f"{cfg.name}: the {cfg.model} graph does not lower "
                         "back to the config (tables differ in combiner, "
                         "strategy or hot_fraction)")
    return m


def dlrm_graph(cfg: RecsysConfig, *, solver: Optional[Solver] = None,
               reader: Optional[DataReaderParams] = None) -> Model:
    """The canonical DLRM recipe graph for a ``model="dlrm"`` config, as
    ``repro/configs/dlrm_criteo.py::build_model`` declares it (tables
    named by ``cfg``); it lowers back to ``cfg``."""
    if cfg.model != "dlrm":
        raise ValueError(f"{cfg.name}: model {cfg.model!r} is not dlrm")
    m = _recipe_model(cfg, solver, reader)
    m.add(DenseLayer("mlp", ["dense"], ["bot"], units=cfg.bottom_mlp,
                     final_activation=True))
    m.add(DenseLayer("dot_interaction", ["bot", "emb"], ["interaction"]))
    m.add(DenseLayer("concat", ["bot", "interaction"], ["top_in"]))
    m.add(DenseLayer("mlp", ["top_in"], ["logit"], units=cfg.top_mlp))
    m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    return _lowers_back(m, cfg)


def dcn_graph(cfg: RecsysConfig, *, solver: Optional[Solver] = None,
              reader: Optional[DataReaderParams] = None) -> Model:
    """DCN as ``repro/configs/dcn_criteo.py::build_model`` declares it:
    the cross net and the deep MLP over concat(dense, emb), combined by a
    1-unit head; it lowers back to ``cfg``."""
    if cfg.model != "dcn":
        raise ValueError(f"{cfg.name}: model {cfg.model!r} is not dcn")
    m = _recipe_model(cfg, solver, reader)
    m.add(DenseLayer("concat", ["dense", "emb"], ["flat"]))
    m.add(DenseLayer("cross", ["flat"], ["crossed"],
                     num_layers=cfg.num_cross_layers))
    m.add(DenseLayer("mlp", ["flat"], ["deep"], units=cfg.top_mlp))
    m.add(DenseLayer("concat", ["crossed", "deep"], ["both"]))
    m.add(DenseLayer("mlp", ["both"], ["logit"], units=(1,)))
    m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    return _lowers_back(m, cfg)


def wdl_graph(cfg: RecsysConfig, *, solver: Optional[Solver] = None,
              reader: Optional[DataReaderParams] = None) -> Model:
    """Wide&Deep as ``repro/configs/wdl_criteo.py::build_model`` declares
    it: the deep tower with its 1-unit head over concat(dense, emb), a
    1-unit wide head over ``[dense, wide]`` (the dim-1 twins), and the
    sigmoid over both logits; it lowers back to ``cfg``."""
    if cfg.model != "wdl":
        raise ValueError(f"{cfg.name}: model {cfg.model!r} is not wdl")
    m = _recipe_model(cfg, solver, reader, wide_name="wide")
    m.add(DenseLayer("concat", ["dense", "emb"], ["flat"]))
    m.add(DenseLayer("mlp", ["flat"], ["deep_out"],
                     units=tuple(cfg.top_mlp) + (1,)))
    m.add(DenseLayer("mlp", ["dense", "wide"], ["wide_out"], units=(1,)))
    m.add(DenseLayer("sigmoid", ["wide_out", "deep_out"], ["prob"]))
    return _lowers_back(m, cfg)


def deepfm_graph(cfg: RecsysConfig, *, solver: Optional[Solver] = None,
                 reader: Optional[DataReaderParams] = None) -> Model:
    """DeepFM as ``repro/configs/deepfm_criteo.py::build_model`` declares
    it: the deep tower over concat(dense, emb), the ``fm`` layer over
    ``[dense, wide, emb]``, and the sigmoid over both; it lowers back to
    ``cfg``."""
    if cfg.model != "deepfm":
        raise ValueError(f"{cfg.name}: model {cfg.model!r} is not deepfm")
    m = _recipe_model(cfg, solver, reader, wide_name="wide")
    m.add(DenseLayer("concat", ["dense", "emb"], ["flat"]))
    m.add(DenseLayer("mlp", ["flat"], ["deep_out"],
                     units=tuple(cfg.top_mlp) + (1,)))
    m.add(DenseLayer("fm", ["dense", "wide", "emb"], ["fm_out"]))
    m.add(DenseLayer("sigmoid", ["fm_out", "deep_out"], ["prob"]))
    return _lowers_back(m, cfg)


def graph_model(cfg: RecsysConfig, *, solver: Optional[Solver] = None,
                reader: Optional[DataReaderParams] = None) -> Model:
    """The graph of a ``model="graph"`` config, rebuilt from the config
    alone: the Input, the primary group, the dim-1 twins of a wide branch,
    each extra group, and the layers of ``cfg.dense_graph``; it lowers
    back to ``cfg`` (so a config whose vocabularies were cut still
    declares, trains and deploys)."""
    if cfg.model != "graph":
        raise ValueError(f"{cfg.name}: model {cfg.model!r} is not graph")
    dense_name, emb_name, wide_name, specs, extras = \
        spec_layers(cfg.dense_graph)
    m = _recipe_model(cfg, solver, reader, emb_name=emb_name,
                      wide_name=wide_name, dense_name=dense_name)
    by_name = {g.name: g for g in cfg.extra_groups}
    for name in extras:
        m.add(_group(by_name[name].tables, by_name[name].dim, name))
    for s in specs:
        m.add(DenseLayer(s.type, s.bottoms, [s.top], units=s.units,
                         num_layers=s.num_layers,
                         final_activation=s.final_activation,
                         start=s.start, stop=s.stop))
    return _lowers_back(m, cfg)


#: the graph function of each recipe, by ``RecsysConfig.model``
RECIPE_GRAPHS = {"dlrm": dlrm_graph, "dcn": dcn_graph, "wdl": wdl_graph,
                 "deepfm": deepfm_graph, "graph": graph_model}


def recipe_graph(cfg: RecsysConfig, *, solver: Optional[Solver] = None,
                 reader: Optional[DataReaderParams] = None) -> Model:
    """The graph of ``cfg`` (:data:`RECIPE_GRAPHS`: a paper recipe, or a
    ``model="graph"`` config's own DAG); it lowers back to ``cfg``."""
    if cfg.model not in RECIPE_GRAPHS:
        raise ValueError(f"{cfg.name}: unknown model {cfg.model!r}")
    return RECIPE_GRAPHS[cfg.model](cfg, solver=solver, reader=reader)


def paper_recipe(arch: str, *, smoke: bool = False,
                 solver: Optional[Solver] = None,
                 reader: Optional[DataReaderParams] = None,
                 mesh=None) -> Model:
    """``configs/<arch>.py::build_model`` of a paper recipe: the graph of
    the registry config ``arch``, or of its smoke cut
    (``reduce_recsys_for_smoke``: six tables of at most 1000 rows, D=16,
    the ``-smoke`` name), compiled onto ``mesh`` when one is given."""
    from repro_torch.configs.registry import (
        RECSYS_ARCHS, reduce_recsys_for_smoke)
    cfg = RECSYS_ARCHS[arch]
    m = recipe_graph(reduce_recsys_for_smoke(cfg) if smoke else cfg,
                     solver=solver, reader=reader)
    m._mesh_override = mesh
    return m


# ---------------------------------------------------------------------------
# Ensemble deployment: several models, one storage backend
# ---------------------------------------------------------------------------

def _hotness_demand(tables: Sequence[EmbeddingTableConfig]) -> int:
    """A model's L1 working-set proxy from its table hotness stats: ids
    per sample x expected hot rows (the ``hot_fraction`` share of each
    vocabulary the planner treats as the hot set)."""
    return max(1, sum(
        t.hotness * max(1, min(t.vocab_size,
                               round(t.vocab_size * t.hot_fraction)))
        for t in tables))


def hotness_cache_capacities(models: Sequence[Model],
                             budget: int) -> Dict[str, int]:
    """Split one total L1 row ``budget`` across ensemble members in
    proportion to their table-hotness working sets (each model gets at
    least 64 rows so a cold member still serves)."""
    demand = {m.name: _hotness_demand(m.cfg.all_tables) for m in models}
    total = sum(demand.values())
    return {name: max(64, int(round(budget * d / total)))
            for name, d in demand.items()}


def deploy_ensemble(models: Sequence[Model], directory: str, *,
                    cache_capacity: Union[int, Dict[str, int],
                                          None] = None,
                    cache_budget: Optional[int] = None,
                    cache_shards: int = 1,
                    refresh_budget: int = 512, max_batch: int = 1024,
                    payload_dtype: str = "f32",
                    rebalance_interval_s: Optional[float] = None,
                    vdb=None, bus=None):
    """Write ONE multi-model serving bundle and return a ready
    :class:`~repro_torch.serve.server.MultiModelServer` (the reference's
    ``api.deploy_ensemble``; either package serves the bundle).

    Every member's tables land in one shared ``pdb/`` (namespaced per
    model on disk), each member's ``graph.json`` and ``dense.npz`` under
    ``<name>/``, and the bundle's ``ps.json`` holds one
    :class:`~repro_torch.configs.base.EnsembleConfig`. The in-process
    server shares one VolatileDB and one message bus across the models,
    with one L1 per model, on each model's device.

    L1 sizing: by default the total row budget (``cache_budget``, default
    ``4096 * len(models)``) is split in proportion to the members'
    table-hotness working sets (:func:`hotness_cache_capacities`);
    ``cache_capacity=<int>`` gives every model the same capacity, and a
    ``{model: rows}`` dict pins some members (the rest keep their
    hotness share). ``rebalance_interval_s`` (off by default) re-splits
    the budget from the observed L1 misses at most once per interval.
    ``payload_dtype`` applies to every member's L1.
    """
    from repro_torch.configs.base import (EnsembleConfig,
                                          ensemble_config_to_dict)
    from repro_torch.core.hps.message_bus import MessageBus
    from repro_torch.core.hps.persistent_db import PersistentDB
    from repro_torch.core.hps.volatile_db import VolatileDB
    from repro_torch.serve.server import MultiModelServer
    if not models:
        raise GraphError("deploy_ensemble needs at least one model")
    names = [m.name for m in models]
    if len(set(names)) != len(names):
        raise GraphError(f"ensemble model names must be unique: {names}")
    for m in models:
        if m._params is None:
            raise RuntimeError(
                f"model {m.name!r}: fit() or load() before deploy")
    for m in models:
        m._require_compiled()
    budget = cache_budget if cache_budget is not None \
        else 4096 * len(models)
    capacities = hotness_cache_capacities(models, budget)
    if isinstance(cache_capacity, int):
        capacities = {m.name: cache_capacity for m in models}
    elif isinstance(cache_capacity, dict):
        unknown = set(cache_capacity) - set(names)
        if unknown:
            raise GraphError(
                f"cache_capacity overrides for unknown models: "
                f"{sorted(unknown)}")
        capacities.update(cache_capacity)
    os.makedirs(directory, exist_ok=True)
    pdb = PersistentDB(os.path.join(directory, "pdb"))   # shared L3
    vdb = vdb if vdb is not None else VolatileDB()       # shared L2
    bus = bus if bus is not None else MessageBus()       # shared bus
    hcfgs = []
    servers = {}
    for m in models:
        hcfg = m._write_bundle_member(
            pdb, directory, m.name, cache_capacity=capacities[m.name],
            cache_shards=cache_shards, refresh_budget=refresh_budget,
            max_batch=max_batch, payload_dtype=payload_dtype)
        hcfgs.append(hcfg)
        servers[m.name] = m._build_server(pdb, hcfg, vdb=vdb, bus=bus)
    ens = EnsembleConfig(models=tuple(hcfgs))
    with open(os.path.join(directory, "ps.json"), "w") as f:
        json.dump(ensemble_config_to_dict(ens), f, indent=1)
    return MultiModelServer(servers, vdb=vdb, pdb=pdb, bus=bus,
                            cache_budget=budget,
                            rebalance_interval_s=rebalance_interval_s)
