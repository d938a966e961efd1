"""Reachability report over the import graph (DEAD001/DEAD002), the twin
of ``repro/analysis/deadcode.py`` for the port.

Walks every module under the source package, extracts its static
imports (plus dotted-module string literals, which cover the
``importlib``-driven recipe registry and config loading), and BFSes
from the entry points:

* **runtime roots** — ``<pkg>.launch.*``, ``<pkg>.api``, the twins of
  the reference's ``examples/`` (``<pkg>.examples.*``, each run by
  ``python -m``), any ``__main__`` module, and whatever the port's own
  scripts import (``chip_smoke.py`` and ``tools/*.py``, as
  ``benchmarks/`` and ``examples/`` are the reference's);
* **test roots** — whatever the port's tests import
  (``tests/test_torch_*.py``).

Rules:

``DEAD001``
    module unreachable from ANY entry point (orphan) — fails
    ``--check``
``DEAD002``
    module reachable only from tests (informational: it may be a test
    utility, or it may be a feature that lost its product entry point)

A string literal that names a package prefix ending in a dot (e.g.
``"repro_torch.configs."``) marks every submodule of that package
reachable — the dynamic-import idiom used by the recipe registry.

Stdlib only (an AST walk).
"""
from __future__ import annotations

import ast
import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis.findings import Finding

#: the port's own scripts, relative to the repository root: their imports
#: are runtime roots
RUNTIME_ROOTS = ("chip_smoke.py", "tools/*.py")
#: the port's tests: their imports are test roots
TEST_ROOTS = ("tests/test_torch_*.py",)


def _py_modules(src_root: str) -> Dict[str, str]:
    """Dotted module name -> file path for the package at ``src_root``."""
    pkg = os.path.basename(os.path.normpath(src_root))
    mods: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, src_root)
            parts = [pkg] + rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            mods[".".join(parts)] = full
    return mods


def _walk_py(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def _root_files(repo_root: str, patterns: Sequence[str]) -> List[str]:
    """The ``.py`` files the glob ``patterns`` (relative to
    ``repo_root``) name; a pattern that names a directory takes every
    ``.py`` file under it."""
    out: List[str] = []
    for pat in patterns:
        for path in sorted(glob.glob(os.path.join(repo_root, pat))):
            if os.path.isdir(path):
                out += _walk_py(path)
            elif path.endswith(".py"):
                out.append(path)
    return out


def _edges_from_file(path: str, mods: Dict[str, str],
                     cur_mod: Optional[str] = None,
                     is_package: bool = False) -> Set[str]:
    try:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
    except (SyntaxError, OSError):
        return set()
    out: Set[str] = set()

    def mark(name: str) -> None:
        """Add ``name`` and its ancestor packages (their __init__ runs)."""
        parts = name.split(".")
        for i in range(1, len(parts) + 1):
            cand = ".".join(parts[:i])
            if cand in mods:
                out.add(cand)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mark(a.name)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                if cur_mod is None:
                    continue
                pkg_parts = cur_mod.split(".")
                if not is_package:
                    pkg_parts = pkg_parts[:-1]
                pkg_parts = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                base = ".".join(pkg_parts + ([base] if base else []))
            if base:
                mark(base)
            for a in node.names:
                if base and f"{base}.{a.name}" in mods:
                    mark(f"{base}.{a.name}")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            s = node.value
            if s in mods:
                mark(s)
            elif s.endswith(".") and "." in s[:-1]:
                # dynamic-import prefix ("repro_torch.configs." + arch):
                # conservatively mark the whole subpackage reachable.
                # Single-component prefixes ("repro_torch.") are ignored
                # as too broad to be a meaningful edge.
                for m in mods:
                    if m.startswith(s):
                        mark(m)
    return out


@dataclass
class Report:
    modules: Dict[str, str]
    runtime: Set[str] = field(default_factory=set)
    test_only: Set[str] = field(default_factory=set)
    orphans: Set[str] = field(default_factory=set)


def reachability(repo_root: str, src_root: str, *,
                 runtime_roots: Sequence[str] = RUNTIME_ROOTS,
                 test_roots: Sequence[str] = TEST_ROOTS) -> Report:
    mods = _py_modules(src_root)
    pkg = os.path.basename(os.path.normpath(src_root))
    edges = {
        m: _edges_from_file(
            p, mods, cur_mod=m,
            is_package=os.path.basename(p) == "__init__.py")
        for m, p in mods.items()}

    def external_seeds(patterns: Sequence[str]) -> Set[str]:
        seeds: Set[str] = set()
        for f in _root_files(repo_root, patterns):
            seeds |= _edges_from_file(f, mods)
        return seeds

    runtime_seeds = {m for m in mods
                     if m == f"{pkg}.api"
                     or m.startswith(f"{pkg}.launch")
                     or m.startswith(f"{pkg}.examples")
                     or m.rsplit(".", 1)[-1] == "__main__"}
    runtime_seeds |= external_seeds(runtime_roots)
    test_seeds = external_seeds(test_roots)

    def bfs(seeds: Set[str]) -> Set[str]:
        seen: Set[str] = set()
        frontier = list(seeds)
        while frontier:
            m = frontier.pop()
            if m in seen or m not in mods:
                continue
            seen.add(m)
            # ancestor packages import too
            parts = m.split(".")
            for i in range(1, len(parts)):
                anc = ".".join(parts[:i])
                if anc in mods and anc not in seen:
                    frontier.append(anc)
            frontier.extend(edges.get(m, ()))
        return seen

    runtime = bfs(runtime_seeds)
    with_tests = bfs(runtime_seeds | test_seeds)
    return Report(modules=mods, runtime=runtime,
                  test_only=with_tests - runtime,
                  orphans=set(mods) - with_tests)


def lint(repo_root: str, src_root: str, *,
         include_test_only: bool = True) -> List[Finding]:
    rep = reachability(repo_root, src_root)
    findings: List[Finding] = []
    for m in sorted(rep.orphans):
        findings.append(Finding(
            rule="DEAD001",
            file=os.path.relpath(rep.modules[m], repo_root),
            line=1,
            message=f"module {m} is unreachable from every entry point "
                    "(launch/*, api, examples/*, __main__, chip_smoke.py, "
                    "tools, tests/test_torch_*)"))
    if include_test_only:
        for m in sorted(rep.test_only):
            findings.append(Finding(
                rule="DEAD002",
                file=os.path.relpath(rep.modules[m], repo_root),
                line=1,
                message=f"module {m} is reachable only from tests",
                advice=True))
    return findings
