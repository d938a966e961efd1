"""Dense-graph compiler and executor (counterpart of
``repro/models/recsys/dense_graph.py``), for the ops the four paper
recipes use: ``mlp``, ``cross``, ``dot_interaction``, ``fm``, ``concat``
and the terminal ``sigmoid``, plus the internal ``first_order`` and
``fm_second`` of the canonical WDL and DeepFM programs.

``compile_layers`` validates the layer DAG (unknown tensors, duplicate
names, cycles, arity, shapes, one terminal, every embedding read, the
dim-1 wide input included), toposorts it and emits a
:class:`DenseGraphProgram`; ``canonical_program`` binds each recipe's
historical parameter names (``bottom``/``top``; ``cross``/``deep``/
``combine``; ``deep``/``dense_w``/``bias``). The remaining ops
(``add|multiply|relu|slice|reduce_sum``) and generic ``model="graph"``
programs raise ``NotImplementedError``: the ROADMAP item "The other
recipes and graphs", part 3b.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import dot_interaction_ref
from repro_torch.models.recsys import layers as dlayers
from repro_torch.roadmap import RECIPES_3B, not_ported

#: params that can never be shadowed by a layer output
RESERVED_NAMES = ("embedding", "wide_embedding")
#: ops this slice executes
PORTED_OPS = ("mlp", "cross", "dot_interaction", "fm", "concat", "sigmoid")
#: internal ops of the canonical WDL and DeepFM programs (never declared)
INTERNAL_OPS = ("first_order", "fm_second")


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
    if s.type == "cross":
        _arity(s, 1, 1)
        if len(bs[0]) != 1:
            raise GraphError(
                f"cross -> {s.top!r} runs over a 2-D feature block, but "
                f"{_fmt(s.bottoms[0], bs[0])} is not [B, n]")
        return bs[0]
    if s.type == "fm":
        _arity(s, 3, 3)
        return ()
    if s.type in INTERNAL_OPS:
        return ()
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
    raise not_ported(f"DenseLayer type {s.type!r}", RECIPES_3B)


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
    reference path. ``inputs`` names the ``dense``, ``emb`` and (wide
    models) ``wide`` tensors.
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
                 wide: Optional[torch.Tensor],
                 compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """Entry casts as in the reference: dense f32, the embedding block
        in the compute dtype, the wide block as delivered (the compute
        dtype from the training lookup, the HPS's f32 when serving)."""
        env = {self.inputs["dense"]: dense.float(),
               self.inputs["emb"]: emb.to(compute_dtype)}
        if self.inputs.get("wide") and wide is not None:
            env[self.inputs["wide"]] = wide
        return env

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
            elif n.op == "cross":
                env[n.output] = dlayers.cross_apply(
                    fetch(n, "p"), xs[0], compute_dtype=compute_dtype)
            elif n.op == "concat":
                # mixed dtypes promote (f32 dense + compute-dtype
                # embeddings -> f32), as jnp.concatenate does
                env[n.output] = torch.cat([x2d(v) for v in xs], dim=1)
            elif n.op == "first_order":
                env[n.output] = _first_order(xs[0], xs[1], fetch(n, "w"),
                                             fetch(n, "b"))
            elif n.op == "fm_second":
                env[n.output] = dlayers.fm_second_order(xs[0]).sum(dim=1)
            elif n.op == "fm":
                p = fetch(n, "p")
                env[n.output] = _first_order(xs[0], xs[1], p["w"], p["b"]) \
                    + dlayers.fm_second_order(xs[2]).sum(dim=1)
            else:                            # pragma: no cover
                raise ValueError(f"uncompiled op {n.op!r}")

        out = None
        for name in self.logit_bottoms:
            v = col(env[name])
            out = v if out is None else out + v
        return out


def _first_order(dense: torch.Tensor, wide: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """WDL's wide logit and DeepFM's first-order term: ``wide [B, T, 1]``
    summed with weight 1, plus ``dense @ w + b``. The sum keeps the wide
    block's dtype, accumulated in f32 and rounded once (``jnp.sum`` of a
    bf16 block), before the f32 add."""
    pooled = wide.sum(dim=(1, 2), dtype=torch.float32).to(wide.dtype)
    return pooled.float() + torch.matmul(dense, w) + b


def compile_layers(specs: Sequence[LayerSpec], *, dense_name: str,
                   num_dense: int, emb_name: str, num_tables: int,
                   emb_dim: int, wide_name: Optional[str] = None,
                   use_kernels: bool = True) -> DenseGraphProgram:
    """Validate + toposort + shape-infer the layer DAG and emit the
    program. ``wide_name`` names the dim-1 wide input ``[T, 1]`` of wide
    models. Failures raise :class:`GraphError` naming the layer or
    tensor; ops beyond :data:`PORTED_OPS` raise ``NotImplementedError``."""
    specs = list(specs)
    for s in specs:
        if s.type not in PORTED_OPS + INTERNAL_OPS:
            raise not_ported(f"DenseLayer type {s.type!r}", RECIPES_3B)
    inputs: Dict[str, Tuple[int, ...]] = {dense_name: (num_dense,),
                                          emb_name: (num_tables, emb_dim)}
    if wide_name:
        inputs[wide_name] = (num_tables, 1)
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
    for name in (emb_name,) + ((wide_name,) if wide_name else ()):
        if name not in consumed:
            raise GraphError(
                f"SparseEmbedding output {name!r} is never read by any "
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
        path = s.param or (s.top,)
        if s.type == "mlp":
            attrs = {"units": tuple(s.units),
                     "final_activation": s.final_activation,
                     "in_dim": sum(_flat_dim(shapes[b]) for b in s.bottoms)}
            params = {"p": path}
        elif s.type == "cross":
            attrs = {"num_layers": s.num_layers,
                     "in_dim": shapes[s.bottoms[0]][0]}
            params = {"p": path}
        elif s.type == "first_order":
            # canonical_program rebinds these to the top-level
            # ("dense_w", "bias") entries
            params = {"w": (s.top, "w"), "b": (s.top, "b")}
        elif s.type == "fm":
            # roles by shape: the 2-D block, the dim-1 3-D block, the
            # embedding 3-D block
            vec = [b for b in s.bottoms if len(shapes[b]) == 1]
            wid = [b for b in s.bottoms
                   if len(shapes[b]) == 2 and shapes[b][1] == 1]
            emb = [b for b in s.bottoms
                   if len(shapes[b]) == 2 and shapes[b][1] != 1]
            if len(vec) != 1 or len(wid) != 1 or len(emb) != 1:
                raise GraphError(
                    f"fm -> {s.top!r} reads [dense features [B, n], "
                    "wide embeddings [B, T, 1], deep embeddings "
                    f"[B, T, D>1]], got shapes "
                    f"{[shapes[b] for b in s.bottoms]} for "
                    f"{list(s.bottoms)}")
            s = dataclasses.replace(s, bottoms=(vec[0], wid[0], emb[0]))
            attrs = {"in_dim": shapes[vec[0]][0]}
            params = {"p": path}
        nodes.append(Node(op=s.type, inputs=tuple(s.bottoms), output=s.top,
                          attrs=attrs, params=params))
    return DenseGraphProgram(
        nodes, shapes,
        {"dense": dense_name, "emb": emb_name, "wide": wide_name},
        logit_bottoms, use_kernels=use_kernels)


def canonical_program(cfg, *, use_kernels: bool = True) -> DenseGraphProgram:
    """The four paper recipes as programs with their historical param
    names, node for node the reference's ``canonical_program``."""
    t, d, nd = len(cfg.tables), cfg.embedding_dim, cfg.num_dense_features

    def mlp(bottoms, top, units, param, final=False):
        return LayerSpec("mlp", tuple(bottoms), top, units=tuple(units),
                         final_activation=final, param=(param,))

    wide = None
    if cfg.model == "dlrm":
        specs = [
            mlp(("dense",), "bot", cfg.bottom_mlp, "bottom", final=True),
            LayerSpec("dot_interaction", ("bot", "emb"), "tri"),
            LayerSpec("concat", ("bot", "tri"), "top_in"),
            mlp(("top_in",), "logit", cfg.top_mlp, "top"),
            LayerSpec("sigmoid", ("logit",), "prob"),
        ]
    elif cfg.model == "dcn":
        specs = [
            LayerSpec("concat", ("dense", "emb"), "flat"),
            LayerSpec("cross", ("flat",), "crossed",
                      num_layers=cfg.num_cross_layers, param=("cross",)),
            mlp(("flat",), "deep_out", cfg.top_mlp, "deep"),
            LayerSpec("concat", ("crossed", "deep_out"), "both"),
            mlp(("both",), "logit", (1,), "combine"),
            LayerSpec("sigmoid", ("logit",), "prob"),
        ]
    elif cfg.model == "deepfm":
        specs = [
            LayerSpec("concat", ("dense", "emb"), "flat"),
            mlp(("flat",), "deep_out", cfg.top_mlp + (1,), "deep"),
            LayerSpec("first_order", ("dense", "wide"), "first"),
            LayerSpec("fm_second", ("emb",), "fm2"),
            LayerSpec("sigmoid", ("first", "fm2", "deep_out"), "prob"),
        ]
        wide = "wide"
    elif cfg.model == "wdl":
        specs = [
            LayerSpec("concat", ("dense", "emb"), "flat"),
            mlp(("flat",), "deep_out", cfg.top_mlp + (1,), "deep"),
            LayerSpec("first_order", ("dense", "wide"), "wide_out"),
            LayerSpec("sigmoid", ("wide_out", "deep_out"), "prob"),
        ]
        wide = "wide"
    else:
        raise not_ported(f"model {cfg.model!r}", RECIPES_3B)
    prog = compile_layers(
        specs, dense_name="dense", num_dense=nd, emb_name="emb",
        num_tables=t, emb_dim=d, wide_name=wide, use_kernels=use_kernels)
    # the canonical tree keeps the first-order params at the top level
    for n in prog.nodes:
        if n.op == "first_order":
            n.params = {"w": ("dense_w",), "b": ("bias",)}
    return prog
