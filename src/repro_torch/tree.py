"""Nested dicts of tensors (the port's parameter and optimizer trees).

Keys are walked in sorted order, as ``jax.tree_util`` flattens a dict, so
a flat key-path (``"/".join`` of the keys) names the same leaf in both
packages: the checkpoint and bundle formats are keyed by these paths.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple


def flatten(tree: Mapping, prefix: str = "") -> List[Tuple[str, object]]:
    """``[(key_path, leaf), ...]`` in sorted-key order."""
    out: List[Tuple[str, object]] = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.extend(flatten(v, path))
        else:
            out.append((path, v))
    return out


def unflatten(flat: Mapping[str, object]) -> Dict:
    """Inverse of :func:`flatten` (given the key paths as a mapping)."""
    out: Dict = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def unflatten_like(template: Mapping, flat: Mapping[str, object],
                   prefix: str = "") -> Dict:
    """:func:`unflatten` into ``template``'s structure: its empty
    subtrees (a zero-layer cross network's ``{}``) come back too, as
    ``jax.tree_util`` keeps them."""
    out: Dict = {}
    for k, v in template.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = (unflatten_like(v, flat, path) if isinstance(v, Mapping)
                  else flat[path])
    return out


def leaves(tree: Mapping) -> List:
    return [v for _, v in flatten(tree)]


def tree_map(fn: Callable, tree: Mapping, *rest: Mapping) -> Dict:
    """``fn`` over matching leaves of ``tree`` and ``rest`` (same keys)."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest))
                if isinstance(v, Mapping)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}
