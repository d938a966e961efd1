"""Dense-graph compiler and executor (counterpart of
``repro/models/recsys/dense_graph.py``), for the op subset the DLRM recipe
uses: ``mlp``, ``dot_interaction``, ``concat`` and the terminal ``sigmoid``.

``compile_layers`` validates the layer DAG (unknown tensors, duplicate
names, cycles, arity, shapes, one terminal, every embedding read),
toposorts it and emits a :class:`DenseGraphProgram`; ``canonical_program``
binds DLRM's historical parameter names (``bottom``, ``top``). Any other
op raises ``NotImplementedError``: the other recipes and generic graphs
are the ROADMAP item "The other recipes and graphs".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import dot_interaction_ref
from repro_torch.models.recsys import layers as dlayers
from repro_torch.roadmap import not_ported

#: params that can never be shadowed by a layer output
RESERVED_NAMES = ("embedding", "wide_embedding")
#: ops this slice executes
PORTED_OPS = ("mlp", "dot_interaction", "concat", "sigmoid")


class GraphError(ValueError):
    """A model graph that cannot be compiled into a dense program."""


@dataclasses.dataclass
class LayerSpec:
    """One dense layer before compilation."""
    type: str
    bottoms: Tuple[str, ...]
    top: str
    units: Tuple[int, ...] = ()
    num_layers: int = 0
    final_activation: bool = False
    start: int = 0
    stop: int = 0
    #: parameter-tree path override (canonical programs bind ("bottom",))
    param: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class Node:
    """One compiled op: inputs resolved, shapes known, params bound."""
    op: str
    inputs: Tuple[str, ...]
    output: str
    attrs: Dict
    params: Dict[str, Tuple[str, ...]]


def spec_from_layer(layer) -> LayerSpec:
    """An ``api.DenseLayer``-shaped object -> :class:`LayerSpec`."""
    return LayerSpec(
        type=layer.type, bottoms=tuple(layer.bottom_names),
        top=layer.top_names[0], units=tuple(layer.units),
        num_layers=int(layer.num_layers),
        final_activation=bool(layer.final_activation),
        start=int(getattr(layer, "start", 0)),
        stop=int(getattr(layer, "stop", 0)))


def _flat_dim(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _fmt(name: str, shape: Tuple[int, ...]) -> str:
    return f"{name!r} [B{''.join(f', {s}' for s in shape)}]"


def _arity(s: LayerSpec, lo: int, hi: Optional[int] = None) -> None:
    n = len(s.bottoms)
    if n < lo or (hi is not None and n > hi):
        want = f"exactly {lo}" if hi == lo else (
            f"at least {lo}" if hi is None else f"{lo}..{hi}")
        raise GraphError(
            f"DenseLayer({s.type}) -> {s.top!r} takes {want} bottom "
            f"tensor(s), got {list(s.bottoms)}")


def _infer_shape(s: LayerSpec, shp: Dict[str, Tuple[int, ...]]
                 ) -> Tuple[int, ...]:
    bs = [shp[b] for b in s.bottoms]
    if s.type == "mlp":
        _arity(s, 1)
        if not s.units:
            raise GraphError(f"DenseLayer(mlp) -> {s.top!r} needs units")
        return (s.units[-1],)
    if s.type == "dot_interaction":
        _arity(s, 2, 2)
        vec, emb = bs
        if len(vec) != 1 or len(emb) != 2:
            raise GraphError(
                f"dot_interaction -> {s.top!r} takes [bottom_mlp_out "
                f"[B, D], embeddings [B, T, D]], got "
                f"{_fmt(s.bottoms[0], vec)} and {_fmt(s.bottoms[1], emb)}")
        if vec[0] != emb[1]:
            raise GraphError(
                f"dot_interaction -> {s.top!r}: bottom mlp must end at "
                f"the embedding dim for the interaction: "
                f"{s.bottoms[0]!r} has {vec[0]} features != embedding "
                f"dim {emb[1]} of {s.bottoms[1]!r}")
        f = emb[0] + 1
        return (f * (f - 1) // 2,)
    if s.type == "concat":
        _arity(s, 1)
        return (sum(_flat_dim(b) for b in bs),)
    if s.type == "sigmoid":
        _arity(s, 1)
        for b, bshape in zip(s.bottoms, bs):
            if bshape not in ((), (1,)):
                raise GraphError(
                    f"sigmoid sums logit-shaped bottoms ([B] or [B, 1]), "
                    f"but {_fmt(b, bshape)} is wider")
        return ()
    raise not_ported(f"DenseLayer type {s.type!r}")


def _toposort(specs: List[LayerSpec], available: set) -> List[LayerSpec]:
    """Kahn's algorithm, stable w.r.t. declaration order."""
    producible = set(available) | {s.top for s in specs}
    for s in specs:
        for b in s.bottoms:
            if b not in producible:
                raise GraphError(
                    f"DenseLayer({s.type}) -> {s.top!r} reads unknown "
                    f"tensor {b!r} (known tensors: {sorted(producible)})")
    done = set(available)
    order: List[LayerSpec] = []
    remaining = list(specs)
    while remaining:
        ready = [s for s in remaining if all(b in done for b in s.bottoms)]
        if not ready:
            raise GraphError(
                f"dependency cycle among DenseLayers producing "
                f"{sorted(s.top for s in remaining)}")
        for s in ready:
            order.append(s)
            done.add(s.top)
        remaining = [s for s in remaining if s not in ready]
    return order


class DenseGraphProgram:
    """A compiled dense graph: topo-ordered nodes and one ``apply``.

    ``use_kernels`` routes ``dot_interaction`` through K2, and its
    gradient through K4 (the wrappers launch the CUDA kernels on CUDA
    tensors); ``False`` runs the plain version on any device, the in-port
    reference path.
    """

    def __init__(self, nodes: List[Node], shapes: Dict[str, Tuple],
                 inputs: Dict[str, Optional[str]],
                 logit_bottoms: Tuple[str, ...], *,
                 use_kernels: bool = True):
        self.nodes = nodes
        self.shapes = shapes
        self.inputs = inputs
        self.logit_bottoms = logit_bottoms
        self.use_kernels = use_kernels

    def make_env(self, dense: torch.Tensor, emb: torch.Tensor,
                 compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Entry casts as in the reference: dense f32, the embedding block
        in the compute dtype."""
        return {self.inputs["dense"]: dense.float(),
                self.inputs["emb"]: emb.to(compute_dtype)}

    def apply(self, params: Dict, env: Dict[str, torch.Tensor],
              compute_dtype: torch.dtype) -> torch.Tensor:
        """Execute the node list; returns the logit column ``[B]``."""

        def fetch(node: Node, local: str):
            p = params
            for k in node.params[local]:
                p = p[k]
            return p

        def x2d(v):
            return v if v.dim() == 2 else v.reshape(v.shape[0], -1)

        def col(v):
            return v if v.dim() == 1 else v.reshape(v.shape[0], -1).sum(1)

        for n in self.nodes:
            xs = [env[i] for i in n.inputs]
            if n.op == "mlp":
                vs = [x2d(v) for v in xs]
                x = vs[0] if len(vs) == 1 else torch.cat(vs, dim=1)
                env[n.output] = dlayers.mlp_apply(
                    fetch(n, "p"), x,
                    final_activation=n.attrs["final_activation"],
                    compute_dtype=compute_dtype)
            elif n.op == "dot_interaction":
                # the f32 bottom output promotes the compute-dtype
                # embeddings to f32, as jnp.concatenate does
                feats = torch.cat([xs[0][:, None, :].float(),
                                   xs[1].float()], dim=1)
                env[n.output] = kops.dot_interaction(feats) \
                    if self.use_kernels else dot_interaction_ref(feats)
            elif n.op == "concat":
                env[n.output] = torch.cat([x2d(v) for v in xs], dim=1)
            else:                            # pragma: no cover
                raise ValueError(f"uncompiled op {n.op!r}")

        out = None
        for name in self.logit_bottoms:
            v = col(env[name])
            out = v if out is None else out + v
        return out


def compile_layers(specs: Sequence[LayerSpec], *, dense_name: str,
                   num_dense: int, emb_name: str, num_tables: int,
                   emb_dim: int, use_kernels: bool = True
                   ) -> DenseGraphProgram:
    """Validate + toposort + shape-infer the layer DAG and emit the
    program. Failures raise :class:`GraphError` naming the layer or
    tensor; ops beyond :data:`PORTED_OPS` raise ``NotImplementedError``."""
    specs = list(specs)
    for s in specs:
        if s.type not in PORTED_OPS:
            raise not_ported(f"DenseLayer type {s.type!r}")
    inputs: Dict[str, Tuple[int, ...]] = {dense_name: (num_dense,),
                                          emb_name: (num_tables, emb_dim)}
    produced = set(inputs)
    for s in specs:
        if s.top in produced:
            raise GraphError(f"duplicate tensor name {s.top!r}")
        if s.top in RESERVED_NAMES or s.top.startswith("embedding@"):
            raise GraphError(
                f"tensor name {s.top!r} is reserved for the embedding "
                "parameter groups")
        produced.add(s.top)

    order = _toposort(specs, set(inputs))
    shapes: Dict[str, Tuple[int, ...]] = dict(inputs)
    for s in order:
        shapes[s.top] = _infer_shape(s, shapes)

    consumed = {b for s in specs for b in s.bottoms}
    for s in specs:
        if s.type == "sigmoid" and s.top in consumed:
            raise GraphError(
                f"sigmoid -> {s.top!r} is a terminal layer; "
                f"{s.top!r} cannot feed another layer")
    terminals = [s for s in specs if s.top not in consumed]
    if not terminals:
        raise GraphError("the graph has no terminal: every layer output "
                         "is consumed by another layer")
    if len(terminals) > 1:
        raise GraphError(
            f"the graph must end in exactly one terminal tensor, got "
            f"{sorted(s.top for s in terminals)}")
    if emb_name not in consumed:
        raise GraphError(
            f"SparseEmbedding output {emb_name!r} is never read by any "
            "DenseLayer")

    term = terminals[0]
    if term.type == "sigmoid":
        logit_bottoms = tuple(term.bottoms)
    else:
        if shapes[term.top] not in ((), (1,)):
            raise GraphError(
                f"terminal tensor {_fmt(term.top, shapes[term.top])} is "
                "not logit-shaped")
        logit_bottoms = (term.top,)

    nodes: List[Node] = []
    for s in order:
        if s.type == "sigmoid":
            continue
        attrs: Dict = {}
        params: Dict[str, Tuple[str, ...]] = {}
        if s.type == "mlp":
            attrs = {"units": tuple(s.units),
                     "final_activation": s.final_activation,
                     "in_dim": sum(_flat_dim(shapes[b]) for b in s.bottoms)}
            params = {"p": s.param or (s.top,)}
        nodes.append(Node(op=s.type, inputs=tuple(s.bottoms), output=s.top,
                          attrs=attrs, params=params))
    return DenseGraphProgram(
        nodes, shapes, {"dense": dense_name, "emb": emb_name},
        logit_bottoms, use_kernels=use_kernels)


def canonical_program(cfg, *, use_kernels: bool = True) -> DenseGraphProgram:
    """DLRM as a program with its historical param names."""
    if cfg.model != "dlrm":
        raise not_ported(f"model {cfg.model!r}")

    def mlp(bottoms, top, units, param, final=False):
        return LayerSpec("mlp", tuple(bottoms), top, units=tuple(units),
                         final_activation=final, param=(param,))

    specs = [
        mlp(("dense",), "bot", cfg.bottom_mlp, "bottom", final=True),
        LayerSpec("dot_interaction", ("bot", "emb"), "tri"),
        LayerSpec("concat", ("bot", "tri"), "top_in"),
        mlp(("top_in",), "logit", cfg.top_mlp, "top"),
        LayerSpec("sigmoid", ("logit",), "prob"),
    ]
    return compile_layers(
        specs, dense_name="dense", num_dense=cfg.num_dense_features,
        emb_name="emb", num_tables=len(cfg.tables),
        emb_dim=cfg.embedding_dim, use_kernels=use_kernels)
