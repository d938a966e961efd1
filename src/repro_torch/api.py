"""HugeCTR-style declarative graph API on one device (counterpart of
``repro/api.py``).

The layer declarations (``Solver``, ``DataReaderParams``, ``Input``,
``SparseEmbedding``, ``DenseLayer``) carry the JAX package's field sets,
so a ``graph.json`` (format ``repro-graph-v1``) written by either package
loads in the other and lowers to the same ``recsys_config_hash``. This
port lowers the canonical DLRM recipe (bottom MLP, dot interaction,
concat, top MLP, sigmoid); any other graph raises ``NotImplementedError``
naming the ROADMAP item that ports it.

The paper's workflow runs through :class:`Model`::

    m = Model(solver, reader, name="dlrm"); m.add(...); ...
    m.compile(device="cuda")      # "cuda" unless device="cpu" is given
    m.fit(steps=100)              # synthetic reader, one device
    m.save("ckpt")                # graph.json + logical checkpoint
    server = m.deploy("bundle")   # pdb/ graph.json dense.npz ps.json

and ``launch/serve.py::build_server_from_config`` (either package's)
serves the bundle. Not ported yet: the ETC backend (``Solver.etc``), the
criteo reader, and meshes of more than one device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import (
    EmbeddingTableConfig, RecsysConfig, TrainConfig, recsys_config_hash,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.recsys.dense_graph import (
    RESERVED_NAMES, GraphError, compile_layers, not_ported, spec_from_layer,
)

GRAPH_FORMAT = "repro-graph-v1"


@dataclasses.dataclass
class Solver:
    """Run-level knobs (HugeCTR's ``CreateSolver``); the JAX package's
    field set, so ``graph.json`` round-trips between the packages.
    Training runs on one device: ``mesh_shape`` of more than one device
    and ``mode="manual"`` raise at ``compile()``."""
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
    #: ETC-staged training knobs in their JSON (dict) form; carried, not
    #: interpreted, until the online-training slice
    etc: Optional[Dict] = None

    def __post_init__(self):
        if self.etc is not None and not isinstance(self.etc, dict):
            raise GraphError(f"Solver.etc must be a dict, got "
                             f"{type(self.etc).__name__}")
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

    def to_tables(self) -> Tuple[EmbeddingTableConfig, ...]:
        names = self.table_names or tuple(
            f"f{i}" for i in range(len(self.vocab_sizes)))
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
    vocabulary; this slice executes mlp, dot_interaction, concat and
    sigmoid)."""
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
# Lowering: layer graph -> RecsysConfig (the canonical DLRM recipe)
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


def lower_graph(name: str, inp: Optional[Input],
                embs: List[SparseEmbedding],
                layers: List[DenseLayer]) -> RecsysConfig:
    """Validate the layer graph and lower it onto the canonical DLRM
    config. :class:`GraphError` names the offending layer or tensor of an
    invalid graph; a valid graph of another shape raises
    ``NotImplementedError``."""
    if inp is None:
        raise GraphError("the graph needs an Input layer")
    if not embs:
        raise GraphError("the graph needs at least one SparseEmbedding")
    _check_embeddings(inp, embs)
    if len(embs) != 1:
        raise not_ported("a graph with several SparseEmbedding groups")
    deep = embs[0]
    compile_layers(
        [spec_from_layer(l) for l in layers], dense_name=inp.dense_name,
        num_dense=inp.dense_dim, emb_name=deep.top_name,
        num_tables=len(deep.vocab_sizes), emb_dim=deep.dim)
    cfg = _classify_dlrm(name, inp, deep, layers)
    if cfg is None:
        raise not_ported("a graph that is not the canonical DLRM recipe")
    return cfg


class Model:
    """A declarative model graph: ``add`` layers, lower with
    :meth:`to_recsys_config`, round-trip through ``graph.json``; then
    ``compile`` / ``fit`` / ``predict`` / ``save`` / ``load`` / ``deploy``
    drive the lowered model on one device."""

    def __init__(self, solver: Optional[Solver] = None,
                 reader: Optional[DataReaderParams] = None, *,
                 name: str = "model"):
        self.solver = solver or Solver()
        self.reader = reader
        self.name = name
        self._input: Optional[Input] = None
        self._embeddings: List[SparseEmbedding] = []
        self._dense_layers: List[DenseLayer] = []
        self.cfg: Optional[RecsysConfig] = None
        self.device: Optional[torch.device] = None
        self._model = None            # lowered RecsysModel
        self._tcfg: Optional[TrainConfig] = None
        self._params = None
        self._opt_state = None
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
                use_kernels: bool = True) -> "Model":
        """Lower the graph and build the model on ``device`` (``cuda``
        unless ``"cpu"`` is given; raises without a card).
        ``use_kernels=False`` runs the plain versions of the kernels."""
        from repro_torch.core.embedding.collection import MULTI_DEVICE
        from repro_torch.models.recsys.model import RecsysModel
        self.cfg = self.to_recsys_config()
        if self.reader is not None and \
                self.reader.num_dense_features != self._input.dense_dim:
            raise GraphError(
                f"reader num_dense_features="
                f"{self.reader.num_dense_features} != Input dense_dim="
                f"{self._input.dense_dim}")
        if self.solver.mesh_shape is not None and \
                int(np.prod(self.solver.mesh_shape)) > 1:
            raise not_ported(f"Solver.mesh_shape={self.solver.mesh_shape}",
                             MULTI_DEVICE)
        if self.solver.mode == "manual":
            raise not_ported('Solver.mode="manual"', MULTI_DEVICE)
        self._tcfg = self.solver.to_train_config()
        self.batch_size = self.solver.batch_size
        self.device = resolve_device(device)
        self._model = RecsysModel(
            self.cfg, device=self.device, use_kernels=use_kernels,
            global_batch=self.batch_size, comm=self.solver.comm)
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
        if r.source != "synthetic":
            raise not_ported(f"DataReaderParams(source={r.source!r})",
                             "Front doors, benchmarks and CI "
                             "(queue 1 item 6)")
        from repro_torch.data.synthetic import SyntheticCTR
        return SyntheticCTR(self.cfg, self.batch_size, seed=r.seed,
                            zipf_a=r.zipf_a).batch

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
        if self.solver.etc is not None:
            raise not_ported("ETC-staged fit() (Solver.etc)",
                             "ETC and online training (queue 1 item 5)")
        if data_fn is None:
            data_fn = self._reader_data_fn()
        from repro_torch.train.trainer import Trainer
        trainer = Trainer(self._model, self._tcfg, data_fn,
                          ckpt_dir=ckpt_dir,
                          ckpt_interval=self.solver.ckpt_interval)
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

    # -- inference ------------------------------------------------------------------

    def predict(self, batch: Dict) -> np.ndarray:
        """Probabilities ``[B]`` for a host batch (``dense``, ``cat``)."""
        if self._params is None:
            raise RuntimeError("fit() or load() before predict()")
        from repro_torch.train.trainer import put_batch
        dev = put_batch({k: v for k, v in batch.items()
                         if k in ("dense", "cat")}, self.device)
        with torch.no_grad():
            return torch.sigmoid(self._model.apply(self._params, dev)) \
                .cpu().numpy()

    # -- persistence ------------------------------------------------------------------

    def save(self, directory: str, step: int = 0) -> str:
        """Write the graph (graph.json) and a logical-layout checkpoint:
        everything :meth:`load` (of either package) needs."""
        if self._params is None:
            raise RuntimeError("nothing to save: fit() or load() first")
        from repro_torch.models.recsys.model import export_logical_params
        from repro_torch.train import checkpoint as ck
        os.makedirs(directory, exist_ok=True)
        self.graph_to_json(os.path.join(directory, "graph.json"))
        ck.save(directory, step,
                {"params": export_logical_params(self._model, self._params)})
        return directory

    @classmethod
    def load(cls, directory: str, *, device: DeviceLike = None) -> "Model":
        """Rebuild a model from :meth:`save` output alone: graph JSON and
        the newest checkpoint. ``predict()`` works at once; ``fit()``
        continues from the loaded weights."""
        from repro_torch.models.recsys.model import import_logical_params
        from repro_torch.train import checkpoint as ck
        m = cls.from_json(os.path.join(directory, "graph.json"))
        m.compile(device=device)
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

    def deploy(self, directory: str, *, cache_capacity: int = 4096,
               max_batch: int = 1024, payload_dtype: str = "f32"):
        """Write the serving bundle (``pdb/`` with every table,
        ``graph.json``, ``dense.npz``, ``ps.json``) and return an
        ``InferenceServer`` rebuilt from it on this model's device. Either
        package's ``build_server_from_config`` serves the bundle."""
        if self._params is None:
            raise RuntimeError("fit() or load() before deploy()")
        from repro_torch.launch.serve import build_server_from_config
        from repro_torch.serve.server import write_bundle
        tables = self._model.embedding.logical_tables(
            self._params["embedding"])
        write_bundle(directory, self, self.dense_params(), tables,
                     cache_capacity=cache_capacity, max_batch=max_batch,
                     payload_dtype=payload_dtype)
        server, _ = build_server_from_config(
            os.path.join(directory, "ps.json"), device=self.device)
        return server

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
    def from_json(cls, path: str) -> "Model":
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != GRAPH_FORMAT:
            raise GraphError(
                f"{path}: unknown graph format {d.get('format')!r}")
        m = cls(Solver(**d["solver"]),
                DataReaderParams(**d["reader"])
                if d.get("reader") else None,
                name=d["name"])
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


def dlrm_graph(cfg: RecsysConfig, *, solver: Optional[Solver] = None,
               reader: Optional[DataReaderParams] = None) -> Model:
    """The canonical DLRM recipe graph for a ``model="dlrm"`` config, as
    ``repro/configs/dlrm_criteo.py::build_model`` declares it (tables
    named by ``cfg``); it lowers back to ``cfg``."""
    if cfg.model != "dlrm":
        raise not_ported(f"model {cfg.model!r}")
    t0 = cfg.tables[0]
    hot = [t.hotness for t in cfg.tables]
    m = Model(solver or Solver(),
              reader or DataReaderParams(
                  num_dense_features=cfg.num_dense_features),
              name=cfg.name)
    m.add(Input(dense_dim=cfg.num_dense_features))
    m.add(SparseEmbedding(
        vocab_sizes=[t.vocab_size for t in cfg.tables],
        dim=cfg.embedding_dim, top_name="emb",
        hotness=hot[0] if len(set(hot)) == 1 else hot,
        combiner=t0.combiner, strategy=t0.strategy,
        hot_fraction=t0.hot_fraction,
        table_names=[t.name for t in cfg.tables]))
    m.add(DenseLayer("mlp", ["dense"], ["bot"], units=cfg.bottom_mlp,
                     final_activation=True))
    m.add(DenseLayer("dot_interaction", ["bot", "emb"], ["interaction"]))
    m.add(DenseLayer("concat", ["bot", "interaction"], ["top_in"]))
    m.add(DenseLayer("mlp", ["top_in"], ["logit"], units=cfg.top_mlp))
    m.add(DenseLayer("sigmoid", ["logit"], ["prob"]))
    if m.to_recsys_config() != cfg:
        raise ValueError(f"{cfg.name}: the DLRM graph does not lower back "
                         "to the config (tables differ in combiner, "
                         "strategy or hot_fraction)")
    return m
