"""Portable model export (paper §2: the HugeCTR->ONNX converter),
counterpart of ``repro/export.py``, writing the same artifact
(``repro-portable-v1``, the same ``OPSET``): a self-describing,
framework-neutral directory another stack loads without this codebase:

    graph.json    — node list (op, inputs, attrs) + model/table metadata
    weights.npz   — all parameters by stable name (embedding tables in
                    LOGICAL layout: mesh-size independent)

``export_recsys`` writes it from the port's ``RecsysModel`` and params;
``load_exported`` + ``run_exported`` execute the graph with nothing but
numpy, so an artifact of either package runs under either executor.

Emission is a walk of the model's compiled ``DenseGraphProgram``
(``models/recsys/dense_graph.py``): no per-architecture code, so the four
canonical recipes and any generic graph export alike; an extra group's
``gather_sum`` reads its own ``cat`` columns from ``col_start``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

OPSET = {"gather_sum", "concat", "relu", "linear", "dot_interaction",
         "cross", "sigmoid", "fm_second_order", "add", "reduce_sum",
         "ewise_add", "ewise_mul", "slice"}


def _np(v) -> np.ndarray:
    """A parameter leaf (a tensor on any device, or an array) as numpy."""
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def _subtree(params: Dict, path) -> Dict:
    """The param sub-tree a program node's path points at."""
    p = params
    for k in path:
        p = p[k]
    return p


def _param(params: Dict, path) -> np.ndarray:
    return _np(_subtree(params, path))


def _emit_mlp(node, params, weights, nodes):
    """One program mlp node -> (optional concat +) a linear chain."""
    prefix = "/".join(node.params["p"])
    pdict = _subtree(params, node.params["p"])
    inp = node.inputs[0]
    if len(node.inputs) > 1:
        nodes.append({"op": "concat", "inputs": list(node.inputs),
                      "output": f"{node.output}__in", "attrs": {}})
        inp = f"{node.output}__in"
    n = len(pdict) // 2
    cur = inp
    final = node.attrs["final_activation"]
    for i in range(n):
        weights[f"{prefix}/w{i}"] = _np(pdict[f"w{i}"])
        weights[f"{prefix}/b{i}"] = _np(pdict[f"b{i}"])
        dst = node.output if i == n - 1 else f"{prefix}_h{i}"
        nodes.append({"op": "linear", "inputs": [cur], "output": dst,
                      "attrs": {"w": f"{prefix}/w{i}",
                                "b": f"{prefix}/b{i}",
                                "relu": i < n - 1 or final}})
        cur = dst


def _emit_first_order(out, dense_in, wide_in, w_name, b_name, w, b,
                      weights, nodes):
    """wide.sum + dense @ w + b as portable reduce_sum/linear/add."""
    weights[w_name] = _np(w)[:, None]
    weights[b_name] = _np(b)[None]
    nodes.append({"op": "reduce_sum", "inputs": [wide_in],
                  "output": f"{out}__ws", "attrs": {}})
    nodes.append({"op": "linear", "inputs": [dense_in],
                  "output": f"{out}__lin",
                  "attrs": {"w": w_name, "b": b_name, "relu": False}})
    return [f"{out}__ws", f"{out}__lin"]


def export_recsys(model, params: Dict, directory: str,
                  model_name: str = "model") -> str:
    """Serialize a ``RecsysModel`` + its params to the portable format by
    walking its compiled dense program."""
    os.makedirs(directory, exist_ok=True)
    cfg = model.cfg
    program = model.program
    weights: Dict[str, np.ndarray] = {}
    nodes: List[Dict] = []

    # -- embeddings: logical (unpadded, de-striped) per-table arrays -------
    emb_out = program.inputs["emb"]
    for name, full in model.embedding.logical_tables(
            params["embedding"]).items():
        weights[f"table/{name}"] = full
    nodes.append({"op": "gather_sum", "inputs": ["cat"],
                  "output": emb_out,
                  "attrs": {"tables": [t.name for t in cfg.tables],
                            "combiners": [t.combiner
                                          for t in cfg.tables]}})
    wide_table_names: List[str] = []
    if model.wide is not None:
        for name, full in model.wide.logical_tables(
                params["wide_embedding"]).items():
            weights[f"table/{name}"] = full
            wide_table_names.append(name)
        nodes.append({"op": "gather_sum", "inputs": ["cat"],
                      "output": program.inputs["wide"] or "wide",
                      "attrs": {"tables": wide_table_names,
                                "combiners": ["sum"] * len(
                                    wide_table_names)}})
    # N-group models: one gather per extra group, reading its own cat
    # column span (col_start; absent/0 on legacy single-group graphs)
    cols = model.group_columns()
    for gname, coll in model.extra.items():
        key = f"embedding@{gname}"
        for name, full in coll.logical_tables(params[key]).items():
            weights[f"table/{name}"] = full
        nodes.append({"op": "gather_sum", "inputs": ["cat"],
                      "output": gname,
                      "attrs": {"tables": [t.name for t in coll.tables],
                                "combiners": [t.combiner
                                              for t in coll.tables],
                                "col_start": cols[key][0]}})

    # -- dense graph: one walk of the compiled program ---------------------
    for node in program.nodes:
        if node.op == "mlp":
            _emit_mlp(node, params, weights, nodes)
        elif node.op == "cross":
            prefix = "/".join(node.params["p"])
            p = _subtree(params, node.params["p"])
            n_cross = len(p) // 2
            for i in range(n_cross):
                weights[f"{prefix}/w{i}"] = _np(p[f"w{i}"])
                weights[f"{prefix}/b{i}"] = _np(p[f"b{i}"])
            nodes.append({"op": "cross", "inputs": [node.inputs[0]],
                          "output": node.output,
                          "attrs": {"layers": n_cross,
                                    "prefix": prefix}})
        elif node.op == "dot_interaction":
            nodes.append({"op": "dot_interaction",
                          "inputs": list(node.inputs),
                          "output": node.output, "attrs": {}})
        elif node.op == "concat":
            nodes.append({"op": "concat", "inputs": list(node.inputs),
                          "output": node.output, "attrs": {}})
        elif node.op == "first_order":
            terms = _emit_first_order(
                node.output, node.inputs[0], node.inputs[1],
                "/".join(node.params["w"]), "/".join(node.params["b"]),
                _param(params, node.params["w"]),
                _param(params, node.params["b"]), weights, nodes)
            nodes.append({"op": "add", "inputs": terms,
                          "output": node.output, "attrs": {}})
        elif node.op == "fm_second":
            nodes.append({"op": "fm_second_order",
                          "inputs": [node.inputs[0]],
                          "output": node.output, "attrs": {}})
        elif node.op == "fm":
            p = _subtree(params, node.params["p"])
            prefix = "/".join(node.params["p"])
            terms = _emit_first_order(
                node.output, node.inputs[0], node.inputs[1],
                f"{prefix}/w", f"{prefix}/b", p["w"], p["b"],
                weights, nodes)
            nodes.append({"op": "fm_second_order",
                          "inputs": [node.inputs[2]],
                          "output": f"{node.output}__fm2", "attrs": {}})
            nodes.append({"op": "add",
                          "inputs": terms + [f"{node.output}__fm2"],
                          "output": node.output, "attrs": {}})
        elif node.op == "add":
            nodes.append({"op": "ewise_add", "inputs": list(node.inputs),
                          "output": node.output, "attrs": {}})
        elif node.op == "multiply":
            nodes.append({"op": "ewise_mul", "inputs": list(node.inputs),
                          "output": node.output, "attrs": {}})
        elif node.op == "relu":
            nodes.append({"op": "relu", "inputs": [node.inputs[0]],
                          "output": node.output, "attrs": {}})
        elif node.op == "slice":
            nodes.append({"op": "slice", "inputs": [node.inputs[0]],
                          "output": node.output,
                          "attrs": {"start": node.attrs["start"],
                                    "stop": node.attrs["stop"]}})
        elif node.op == "reduce_sum":
            nodes.append({"op": "reduce_sum", "inputs": [node.inputs[0]],
                          "output": node.output, "attrs": {}})
        else:                                # pragma: no cover
            raise NotImplementedError(f"export for op {node.op}")

    # -- terminal: sum the logit bottoms, then the probability -------------
    if len(program.logit_bottoms) == 1:
        logit_name = program.logit_bottoms[0]
    else:
        logit_name = "logit" if "logit" not in program.shapes \
            else "__logit"
        nodes.append({"op": "add", "inputs": list(program.logit_bottoms),
                      "output": logit_name, "attrs": {}})
    nodes.append({"op": "sigmoid", "inputs": [logit_name],
                  "output": "prob", "attrs": {}})

    from repro_torch.configs.base import recsys_config_hash
    from repro_torch.models.recsys.model import wide_tables
    all_tables = cfg.tables + (wide_tables(cfg)
                               if model.wide is not None else ())
    for g in cfg.extra_groups:
        all_tables = all_tables + tuple(g.tables)
    graph = {
        "format": "repro-portable-v1",
        "model": model_name,
        "kind": cfg.model,
        "config_hash": recsys_config_hash(cfg),
        "num_dense_features": cfg.num_dense_features,
        "embedding_dim": cfg.embedding_dim,
        "dense_input": program.inputs["dense"],
        "tables": [{"name": t.name, "vocab": t.vocab_size,
                    "dim": t.dim, "hotness": t.hotness,
                    "combiner": t.combiner} for t in all_tables],
        "nodes": nodes,
    }
    with open(os.path.join(directory, "graph.json"), "w") as f:
        json.dump(graph, f, indent=1)
    np.savez(os.path.join(directory, "weights.npz"), **weights)
    return directory


def load_exported(directory: str):
    """``(graph dict, weights by name)`` of an exported directory."""
    with open(os.path.join(directory, "graph.json")) as f:
        graph = json.load(f)
    with np.load(os.path.join(directory, "weights.npz")) as data:
        weights = {k: data[k] for k in data.files}
    return graph, weights


def run_exported(graph: Dict, weights: Dict[str, np.ndarray],
                 batch: Dict[str, np.ndarray]) -> np.ndarray:
    """Pure-numpy executor: probabilities ``[B]`` for a host batch
    (``dense``, ``cat``), the cross-framework parity check."""
    env: Dict[str, np.ndarray] = {
        graph.get("dense_input", "dense"):
            np.asarray(batch["dense"], np.float32)}
    cat = np.asarray(batch["cat"])

    def _col(x: np.ndarray) -> np.ndarray:
        """Any logit-shaped tensor -> [B] (flattens a trailing 1-dim)."""
        return x.reshape(len(cat), -1).sum(axis=1)

    def _2d(x: np.ndarray) -> np.ndarray:
        """Any tensor -> [B, n] (3-D embedding blocks flatten)."""
        return x.reshape(x.shape[0], -1)

    for node in graph["nodes"]:
        op, out = node["op"], node["output"]
        a = node["attrs"]
        if op == "gather_sum":
            combiners = a.get("combiners") or [
                graph["tables"][ti]["combiner"]
                for ti in range(len(a["tables"]))]
            outs = []
            col0 = a.get("col_start", 0)
            for ti, tname in enumerate(a["tables"]):
                tab = weights[f"table/{tname}"]
                ids = cat[:, col0 + ti, :]
                valid = ids >= 0
                rows = tab[np.clip(ids, 0, None)]
                rows = rows * valid[..., None]
                pooled = rows.sum(axis=1)
                if combiners[ti] == "mean":
                    pooled = pooled / np.maximum(
                        valid.sum(1, keepdims=True), 1)
                outs.append(pooled)
            env[out] = np.stack(outs, axis=1)
            env[f"{out}_flat"] = env[out].reshape(len(cat), -1)
        elif op == "linear":
            x = _2d(env[node["inputs"][0]])
            h = x @ weights[a["w"]] + weights[a["b"]]
            env[out] = np.maximum(h, 0) if a["relu"] else h
        elif op == "concat":
            env[out] = np.concatenate(
                [_2d(env[i]) for i in node["inputs"]], axis=1)
        elif op == "dot_interaction":
            bot, emb = env[node["inputs"][0]], env[node["inputs"][1]]
            feats = np.concatenate([bot[:, None, :], emb], axis=1)
            gram = np.einsum("bfd,bgd->bfg", feats, feats)
            i, j = np.tril_indices(feats.shape[1], -1)
            env[out] = gram[:, i, j]
        elif op == "cross":
            prefix = a.get("prefix", "cross")
            x0 = env[node["inputs"][0]]
            x = x0
            for i in range(a["layers"]):
                xw = x @ weights[f"{prefix}/w{i}"]
                x = x0 * xw[:, None] + weights[f"{prefix}/b{i}"] + x
            env[out] = x
        elif op == "reduce_sum":
            env[out] = _col(env[node["inputs"][0]])
        elif op == "fm_second_order":
            e = env[node["inputs"][0]]       # [B, T, D]
            s = e.sum(axis=1)
            sq = (e * e).sum(axis=1)
            env[out] = (0.5 * (s * s - sq)).sum(axis=1)
        elif op == "add":
            env[out] = np.sum([_col(env[i]) for i in node["inputs"]],
                              axis=0)
        elif op == "ewise_add":
            acc = env[node["inputs"][0]]
            for i in node["inputs"][1:]:
                acc = acc + env[i]
            env[out] = acc
        elif op == "ewise_mul":
            acc = env[node["inputs"][0]]
            for i in node["inputs"][1:]:
                acc = acc * env[i]
            env[out] = acc
        elif op == "relu":
            env[out] = np.maximum(env[node["inputs"][0]], 0)
        elif op == "slice":
            env[out] = _2d(env[node["inputs"][0]])[:,
                                                   a["start"]:a["stop"]]
        elif op == "sigmoid":
            env[out] = 1.0 / (1.0 + np.exp(-env[node["inputs"][0]]))
        else:
            raise ValueError(f"unknown op {op}")
    return env["prob"][:, 0] if env["prob"].ndim == 2 else env["prob"]
