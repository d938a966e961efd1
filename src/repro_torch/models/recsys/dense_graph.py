"""Dense-graph compiler and executor (counterpart of
``repro/models/recsys/dense_graph.py``).

``compile_layers`` validates a layer DAG (unknown tensors, duplicate
names, cycles, arity, shapes, one terminal, every embedding input read:
the primary group, the dim-1 wide twins and each extra group), toposorts
it and emits a :class:`DenseGraphProgram`, whose ``apply`` runs the node
list and whose ``init`` draws every param-bearing node's weights. The ops
are the reference's: ``mlp``, ``cross``, ``dot_interaction``, ``fm``,
``concat``, ``add``, ``multiply``, ``relu``, ``slice``, ``reduce_sum``
and the terminal ``sigmoid``, plus the internal ``first_order`` and
``fm_second`` of the canonical WDL and DeepFM programs.
``canonical_program`` binds each paper recipe's historical parameter
names (``bottom``/``top``; ``cross``/``deep``/``combine``;
``deep``/``dense_w``/``bias``); :func:`program_for` compiles any config,
``model="graph"`` from its serialized ``dense_graph``
(:func:`graph_spec` / :func:`spec_layers`).

Shapes are per sample: ``(n,)`` a ``[B, n]`` feature block, ``(T, D)`` a
pooled embedding block ``[B, T, D]``, ``()`` a logit column ``[B]``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import dot_interaction_ref
from repro_torch.models.recsys import layers as dlayers

#: params that can never be shadowed by a layer output
RESERVED_NAMES = ("embedding", "wide_embedding")
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


# -- the serializable spec (RecsysConfig.dense_graph) ------------------------

def graph_spec(dense_name: str, emb_name: str, wide_name: Optional[str],
               specs: Sequence[LayerSpec],
               extras: Sequence[str] = ()) -> Tuple:
    """The hashable tuple embedded in ``RecsysConfig.dense_graph``: one
    ``("inputs", dense, emb, wide)`` header (a 5th element names the extra
    embedding inputs of an N-group model, omitted when there are none)
    and one ``(type, bottoms, top, attrs)`` tuple per layer, exactly as
    the reference writes it (so the config hash agrees)."""
    head: Tuple = ("inputs", dense_name, emb_name, wide_name or "")
    if extras:
        head = head + (tuple(extras),)
    out: List[Tuple] = [head]
    for s in specs:
        attrs: List[Tuple] = []
        if s.type == "mlp":
            attrs = [("final_activation", s.final_activation),
                     ("units", tuple(s.units))]
        elif s.type == "cross":
            attrs = [("num_layers", s.num_layers)]
        elif s.type == "slice":
            attrs = [("start", s.start), ("stop", s.stop)]
        out.append((s.type, tuple(s.bottoms), s.top, tuple(attrs)))
    return tuple(out)


def spec_layers(dense_graph: Tuple) -> Tuple[str, str, Optional[str],
                                             List[LayerSpec],
                                             Tuple[str, ...]]:
    """Inverse of :func:`graph_spec`: ``(dense, emb, wide or None, specs,
    extra input names)``."""
    if not dense_graph or dense_graph[0][0] != "inputs":
        raise GraphError("dense_graph spec is missing its inputs header")
    head = dense_graph[0]
    _, dense_name, emb_name, wide_name = head[:4]
    extras = tuple(head[4]) if len(head) > 4 else ()
    specs = []
    for typ, bottoms, top, attrs in dense_graph[1:]:
        kw = dict(attrs)
        specs.append(LayerSpec(
            type=typ, bottoms=tuple(bottoms), top=top,
            units=tuple(kw.get("units", ())),
            num_layers=int(kw.get("num_layers", 0)),
            final_activation=bool(kw.get("final_activation", False)),
            start=int(kw.get("start", 0)), stop=int(kw.get("stop", 0))))
    return dense_name, emb_name, (wide_name or None), specs, extras


def dense_graph_from_jsonable(g) -> Tuple:
    """Rebuild the tuple spec from its JSON (lists) form."""
    if not g:
        return ()
    head = list(g[0])
    if len(head) > 4:
        head[4] = tuple(head[4])
    out: List[Tuple] = [tuple(head)]
    for typ, bottoms, top, attrs in g[1:]:
        out.append((typ, tuple(bottoms), top,
                    tuple((k, tuple(v) if isinstance(v, (list, tuple))
                           else v) for k, v in attrs)))
    return tuple(out)


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
    if s.type in ("add", "multiply"):
        _arity(s, 2)
        for b, bshape in zip(s.bottoms[1:], bs[1:]):
            if bshape != bs[0]:
                raise GraphError(
                    f"{s.type} -> {s.top!r} needs equal shapes, but "
                    f"{_fmt(b, bshape)} != {_fmt(s.bottoms[0], bs[0])}")
        return bs[0]
    if s.type == "relu":
        _arity(s, 1, 1)
        return bs[0]
    if s.type == "slice":
        _arity(s, 1, 1)
        if len(bs[0]) != 1:
            raise GraphError(
                f"slice -> {s.top!r} cuts a 2-D feature block, but "
                f"{_fmt(s.bottoms[0], bs[0])} is not [B, n]")
        if not (0 <= s.start < s.stop <= bs[0][0]):
            raise GraphError(
                f"slice -> {s.top!r}: [{s.start}:{s.stop}] out of range "
                f"for {_fmt(s.bottoms[0], bs[0])}")
        return (s.stop - s.start,)
    if s.type == "reduce_sum":
        _arity(s, 1, 1)
        return ()
    if s.type == "sigmoid":
        _arity(s, 1)
        for b, bshape in zip(s.bottoms, bs):
            if bshape not in ((), (1,)):
                raise GraphError(
                    f"sigmoid sums logit-shaped bottoms ([B] or [B, 1]), "
                    f"but {_fmt(b, bshape)} is wider; end the branch "
                    "with a 1-unit head or a reduce_sum")
        return ()
    raise GraphError(f"unknown DenseLayer type {s.type!r}")


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
    """A compiled dense graph: topo-ordered nodes, per-tensor shapes, one
    ``apply`` and a per-layer ``init``.

    ``use_kernels`` routes ``dot_interaction`` through K2, and its
    gradient through K4 (the wrappers launch the CUDA kernels on CUDA
    tensors); ``False`` runs the plain version on any device, the in-port
    reference path. ``inputs`` names the ``dense``, ``emb``, (wide models)
    ``wide`` and (N-group models) ``extras`` tensors.
    """

    def __init__(self, nodes: List[Node], shapes: Dict[str, Tuple],
                 inputs: Dict, logit_bottoms: Tuple[str, ...], *,
                 use_kernels: bool = True):
        self.nodes = nodes
        self.shapes = shapes
        self.inputs = inputs
        self.logit_bottoms = logit_bottoms
        self.use_kernels = use_kernels

    def init(self, generator: torch.Generator, *, device=None) -> Dict:
        """Weights of every param-bearing node (``mlp``, ``cross``,
        ``fm``), keyed by the node's param path, drawn in node order from
        ``generator`` (a CPU generator) and moved to ``device``: the
        reference's tree and shapes (its ``jax.random`` draws cannot be
        reproduced; parity runs start from its exported values)."""
        params: Dict = {}
        for n in self.nodes:
            if n.op == "mlp":
                p = dlayers.mlp_init(generator, n.attrs["in_dim"],
                                     n.attrs["units"], device=device)
            elif n.op == "cross":
                p = dlayers.cross_init(generator, n.attrs["in_dim"],
                                       n.attrs["num_layers"], device=device)
            elif n.op == "fm":
                p = {"w": (torch.randn((n.attrs["in_dim"],),
                                       generator=generator)
                           * 0.01).to(device),
                     "b": torch.zeros((), device=device)}
            else:
                continue
            params[n.params["p"][0]] = p
        return params

    def make_env(self, dense: torch.Tensor, emb: torch.Tensor,
                 wide: Optional[torch.Tensor], compute_dtype: torch.dtype,
                 extras: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Entry casts as in the reference: dense f32, the embedding block
        and each extra group's block in the compute dtype, the wide block
        as delivered (the compute dtype from the training lookup, the
        HPS's f32 when serving)."""
        env = {self.inputs["dense"]: dense.float(),
               self.inputs["emb"]: emb.to(compute_dtype)}
        if self.inputs.get("wide") and wide is not None:
            env[self.inputs["wide"]] = wide
        for name in self.inputs.get("extras", ()):
            env[name] = extras[name].to(compute_dtype)
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
                # zero layers: the identity, with no params (an empty
                # group has no leaf, so the flat forms do not keep it)
                p = fetch(n, "p") if n.attrs["num_layers"] else {}
                env[n.output] = dlayers.cross_apply(
                    p, xs[0], compute_dtype=compute_dtype)
            elif n.op == "concat":
                # mixed dtypes promote (f32 dense + compute-dtype
                # embeddings -> f32), as jnp.concatenate does
                env[n.output] = torch.cat([x2d(v) for v in xs], dim=1)
            elif n.op == "add":
                out = xs[0]
                for v in xs[1:]:
                    out = out + v
                env[n.output] = out
            elif n.op == "multiply":
                out = xs[0]
                for v in xs[1:]:
                    out = out * v
                env[n.output] = out
            elif n.op == "relu":
                env[n.output] = torch.relu(xs[0])
            elif n.op == "slice":
                env[n.output] = xs[0][:, n.attrs["start"]:n.attrs["stop"]]
            elif n.op == "reduce_sum":
                env[n.output] = col(xs[0])
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
                   extra_embs: Optional[Dict[str, Tuple[int, int]]] = None,
                   use_kernels: bool = True) -> DenseGraphProgram:
    """Validate + toposort + shape-infer the layer DAG and emit the
    program. ``wide_name`` names the dim-1 wide input ``[T, 1]`` of wide
    models; ``extra_embs`` maps each extra embedding group's name to its
    per-sample ``(tables, dim)``. Failures raise :class:`GraphError`
    naming the layer or tensor."""
    specs = list(specs)
    extra_embs = dict(extra_embs or {})
    inputs: Dict[str, Tuple[int, ...]] = {dense_name: (num_dense,),
                                          emb_name: (num_tables, emb_dim)}
    if wide_name:
        inputs[wide_name] = (num_tables, 1)
    for name, (t_n, d_n) in extra_embs.items():
        if name in inputs:
            raise GraphError(
                f"extra SparseEmbedding group name {name!r} collides "
                "with another graph input")
        inputs[name] = (t_n, d_n)
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
    for name in (emb_name,) + ((wide_name,) if wide_name else ()) \
            + tuple(extra_embs):
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
        elif s.type == "slice":
            attrs = {"start": s.start, "stop": s.stop}
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
        {"dense": dense_name, "emb": emb_name, "wide": wide_name,
         "extras": tuple(extra_embs)},
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
        raise ValueError(f"no canonical program for model {cfg.model!r}")
    prog = compile_layers(
        specs, dense_name="dense", num_dense=nd, emb_name="emb",
        num_tables=t, emb_dim=d, wide_name=wide, use_kernels=use_kernels)
    # the canonical tree keeps the first-order params at the top level
    for n in prog.nodes:
        if n.op == "first_order":
            n.params = {"w": ("dense_w",), "b": ("bias",)}
    return prog


def program_for(cfg, *, use_kernels: bool = True) -> DenseGraphProgram:
    """The program of any config: a paper recipe's canonical program, or
    ``cfg.dense_graph`` compiled for ``model="graph"``."""
    if cfg.model != "graph":
        return canonical_program(cfg, use_kernels=use_kernels)
    dense_name, emb_name, wide_name, specs, extras = \
        spec_layers(cfg.dense_graph)
    by_name = {g.name: g for g in cfg.extra_groups}
    missing = [n for n in extras if n not in by_name]
    if missing:
        raise GraphError(
            f"dense_graph header names extra embedding inputs {missing} "
            "with no matching extra_groups entry in the config")
    return compile_layers(
        specs, dense_name=dense_name, num_dense=cfg.num_dense_features,
        emb_name=emb_name, num_tables=len(cfg.tables),
        emb_dim=cfg.embedding_dim, wide_name=wide_name,
        extra_embs={n: (len(by_name[n].tables), by_name[n].dim)
                    for n in extras},
        use_kernels=use_kernels)
