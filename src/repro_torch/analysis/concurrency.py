"""Lock-discipline lint for the port's serving stack (LOCK001-LOCK004), a
copy of ``repro/analysis/concurrency.py`` whose blocking table also knows
PyTorch's host syncs.

A two-phase AST pass over the source tree:

1. **Collect.** Every concurrent class declares its contract with a
   plain class attribute ``_GUARDED_BY = {"attr": "_lockattr", ...}``.
   The pass also records which instance attributes hold
   ``threading.Lock``/``RLock`` objects, which attributes are instances
   of other collected classes (from ``__init__`` assignments, parameter
   annotations and ``self.x: T`` annotations), and the optional
   ``_LOCKS_OF = {"attr": ("Class._lock", ...)}`` declaration for
   injected callables whose lock footprint the AST cannot see (e.g.
   ``DeviceEmbeddingCache.fetch_fn``, the HPS L2/L3 fall-through).

2. **Analyze.** Each method body is walked with the set of HELD locks
   tracked through ``with self._lock:`` scopes. A method whose name
   ends in ``_locked`` is analyzed as if the class's primary lock is
   held, and calling one without that lock is its own finding. Nested
   functions and lambdas run later, usually on another thread, so they
   start with no lock held.

Rules:

``LOCK001``
    guarded attribute accessed outside its declared lock
``LOCK002``
    blocking call while holding a lock: L2/L3 fetch, ``time.sleep``,
    bus poll/publish, future ``.result``, thread ``.join``, pool
    ``.shutdown``, a host sync of a tensor (``.item()``, ``.cpu()``,
    ``.numpy()``, ``.tolist()``), ``torch.cuda.synchronize`` or a
    stream's or event's ``.synchronize()``, or a ``np.asarray``/
    ``np.array`` forcing a device->host copy (argument visibly produces
    a device value). Slow IO and device syncs never run under a lock.
``LOCK003``
    lock-order cycle in the static acquisition graph (including
    re-acquiring a non-reentrant lock)
``LOCK004``
    ``*_locked`` method called without holding the lock

Intentional exceptions carry an inline waiver on the offending line or
the line directly above::

    # lock-ok: LOCK002 <why this blocking call must hold the lock>

Waived findings are reported (tagged) but do not fail ``--check``.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, waiver_on

#: call-path suffixes treated as blocking/slow while a lock is held: the
#: reference's table, then PyTorch's host syncs
BLOCKING_SUFFIXES: Tuple[Tuple[str, ...], ...] = (
    ("time", "sleep"),
    ("jax", "block_until_ready"),
    ("block_until_ready",),
    ("fetch_fn",),                   # the injected L2/L3 fall-through
    ("pdb", "fetch"), ("pdb", "upsert"),
    ("vdb", "query"), ("vdb", "insert"), ("vdb", "evict"),
    ("bus", "fetch"), ("bus", "publish"),
    ("consumer", "poll"),
    ("apply_updates",),
    ("refresh_step",), ("refresh_chunk",), ("refresh_once",),
    ("refresh_caches",),
    ("result",), ("join",), ("shutdown",),
    # a tensor's value on the host waits for the device (and copies)
    ("item",), ("cpu",), ("numpy",), ("tolist",),
    # torch.cuda.synchronize, Stream.synchronize, Event.synchronize and
    # the port's own fence (repro_torch.device.synchronize)
    ("synchronize",),
)
#: suffix-colliding helpers that are NOT blocking: the reference's, and
#: a numpy array's ``tolist`` / ``item``, host-only (a device value fed
#: to ``np.asarray`` is NUMPY_SYNC_CALLS' finding)
NONBLOCKING_OVERRIDES: Tuple[Tuple[str, ...], ...] = (
    ("os", "path", "join"), ("path", "join"), ("sep", "join"),
    ("np", "asarray", "tolist"), ("np", "array", "tolist"),
    ("np", "asarray", "item"), ("np", "array", "item"),
)
#: numpy entry points that force a device->host transfer when handed a
#: live device value
NUMPY_SYNC_CALLS = {("np", "asarray"), ("np", "array"),
                    ("numpy", "asarray"), ("numpy", "array")}
#: attribute calls whose result is (or binds) a device value — feeding
#: one into ``np.asarray`` under a lock is a device sync under a lock
DEVICE_PRODUCING = {"snapshot", "gather", "commit", "block_until_ready"}


@dataclass
class ClassInfo:
    name: str
    file: str                                   # repo-relative path
    line: int = 0
    guarded: Dict[str, str] = field(default_factory=dict)
    locks: Dict[str, str] = field(default_factory=dict)  # attr -> kind
    attr_types: Dict[str, Set[str]] = field(default_factory=dict)
    locks_of: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    methods: Set[str] = field(default_factory=set)
    #: method name -> own lock attrs its body acquires directly
    method_acquires: Dict[str, Set[str]] = field(default_factory=dict)

    @property
    def primary_lock(self) -> Optional[str]:
        if "_lock" in self.locks:
            return "_lock"
        if len(self.locks) == 1:
            return next(iter(self.locks))
        return None

    def qual(self, lockattr: str) -> str:
        return f"{self.name}.{lockattr}"


def _dotted(node: ast.AST) -> Tuple[str, ...]:
    """Call-path of an expression: ``self.vdb.query`` ->
    ``("self", "vdb", "query")``. Subscripts/calls are skipped; a
    non-name base becomes ``"?"``."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            break
        else:
            parts.append("?")
            break
    return tuple(reversed(parts))


def _annotation_names(node: Optional[ast.AST]) -> Set[str]:
    """Class names referenced by an annotation (quoted forms parsed)."""
    out: Set[str] = set()
    if node is None:
        return out
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            try:
                out |= _annotation_names(ast.parse(n.value, mode="eval"))
            except SyntaxError:
                pass
    return out


def _is_lock_ctor(value: ast.AST) -> Optional[str]:
    if not isinstance(value, ast.Call):
        return None
    path = _dotted(value.func)
    if path[-1] in ("Lock", "RLock") and \
            (len(path) == 1 or path[-2] == "threading"):
        return "rlock" if path[-1] == "RLock" else "lock"
    return None


def _const_str_dict(value: ast.AST) -> Dict[str, object]:
    out: Dict[str, object] = {}
    if not isinstance(value, ast.Dict):
        return out
    for k, v in zip(value.keys, value.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            continue
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            out[k.value] = v.value
        elif isinstance(v, (ast.Tuple, ast.List)):
            elems = tuple(e.value for e in v.elts
                          if isinstance(e, ast.Constant)
                          and isinstance(e.value, str))
            out[k.value] = elems
    return out


def _scan_init(fn: ast.FunctionDef, info: ClassInfo) -> None:
    """Harvest lock attrs and attr->class bindings from ``__init__``."""
    ann_of_param: Dict[str, Set[str]] = {}
    args = fn.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        names = _annotation_names(a.annotation)
        if names:
            ann_of_param[a.arg] = names

    for node in ast.walk(fn):
        target = None
        value = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        if not (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            continue
        attr = target.attr
        if isinstance(node, ast.AnnAssign):
            names = _annotation_names(node.annotation)
            if names:
                info.attr_types.setdefault(attr, set()).update(names)
        if value is None:
            continue
        kind = _is_lock_ctor(value)
        if kind:
            info.locks[attr] = kind
            continue
        types: Set[str] = set()
        for n in ast.walk(value):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                types.add(n.func.id)
            elif isinstance(n, ast.Name) and n.id in ann_of_param:
                types |= ann_of_param[n.id]
        if types:
            info.attr_types.setdefault(attr, set()).update(types)


def _collect_class(node: ast.ClassDef, relpath: str) -> ClassInfo:
    info = ClassInfo(name=node.name, file=relpath, line=node.lineno)
    fns = [s for s in node.body
           if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for stmt in node.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            tname = stmt.targets[0].id
            if tname == "_GUARDED_BY":
                info.guarded = {k: v for k, v in
                                _const_str_dict(stmt.value).items()
                                if isinstance(v, str)}
            elif tname == "_LOCKS_OF":
                info.locks_of = {k: v for k, v in
                                 _const_str_dict(stmt.value).items()
                                 if isinstance(v, tuple)}
    for fn in fns:
        info.methods.add(fn.name)
        if fn.name == "__init__":
            _scan_init(fn, info)
    # a guard declaration implies the lock attr even if the collector
    # did not spot its constructor
    for lockattr in set(info.guarded.values()) - set(info.locks):
        info.locks[lockattr] = "unknown"
    for fn in fns:
        acquires: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Attribute) \
                            and isinstance(ce.value, ast.Name) \
                            and ce.value.id == "self" \
                            and ce.attr in info.locks:
                        acquires.add(ce.attr)
        info.method_acquires[fn.name] = acquires
    return info


class _Edges:
    """Static lock-acquisition graph: qualified lock -> qualified lock,
    with the first site that produced each edge."""

    def __init__(self) -> None:
        self.graph: Dict[str, Set[str]] = {}
        self.site: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add(self, src: str, dst: str, file: str, line: int,
            symbol: str) -> None:
        self.graph.setdefault(src, set()).add(dst)
        self.site.setdefault((src, dst), (file, line, symbol))


class _Analyzer:
    def __init__(self, classes: Dict[str, ClassInfo],
                 lock_kind: Dict[str, str]) -> None:
        self.classes = classes
        self.lock_kind = lock_kind
        self.findings: List[Finding] = []
        self.edges = _Edges()
        self._seen: Set[Tuple] = set()
        self._acq_memo: Dict[str, Set[str]] = {}

    # -- transitive lock footprint per class ---------------------------------

    def may_acquire(self, cls_name: str,
                    _stack: Tuple[str, ...] = ()) -> Set[str]:
        if cls_name in self._acq_memo:
            return self._acq_memo[cls_name]
        if cls_name in _stack:
            return set()
        cls = self.classes.get(cls_name)
        if cls is None:
            return set()
        out = {cls.qual(la) for la in cls.locks}
        for targets in cls.locks_of.values():
            out |= set(targets)
        for types in cls.attr_types.values():
            for t in types:
                out |= self.may_acquire(t, _stack + (cls_name,))
        if not _stack:
            self._acq_memo[cls_name] = out
        return out

    # -- per-file analysis ---------------------------------------------------

    def analyze_file(self, relpath: str, tree: ast.Module,
                     lines: List[str]) -> None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                cls = self.classes.get(node.name)
                if cls is None or not cls.locks:
                    continue
                for stmt in node.body:
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._analyze_method(cls, stmt, relpath, lines)

    def _report(self, rule: str, relpath: str, line: int, msg: str,
                symbol: str, lines: List[str]) -> None:
        key = (relpath, rule, line, msg)
        if key in self._seen:
            return
        self._seen.add(key)
        reason = waiver_on(lines, line, rule)
        self.findings.append(Finding(
            rule=rule, file=relpath, line=line, message=msg,
            symbol=symbol, waived=reason is not None,
            waive_reason=reason or ""))

    def _analyze_method(self, cls: ClassInfo, fn: ast.FunctionDef,
                        relpath: str, lines: List[str]) -> None:
        if fn.name in ("__init__", "__del__"):
            return      # construction/teardown is single-threaded
        held: FrozenSet[str] = frozenset()
        if fn.name.endswith("_locked") and cls.primary_lock:
            held = frozenset({cls.qual(cls.primary_lock)})
        symbol = f"{cls.name}.{fn.name}"
        ctx = (cls, relpath, lines, symbol)
        for stmt in fn.body:
            self._visit(stmt, held, ctx)

    def _lock_of_with_item(self, ce: ast.AST,
                           cls: ClassInfo) -> Optional[str]:
        if isinstance(ce, ast.Attribute) \
                and isinstance(ce.value, ast.Name) \
                and ce.value.id == "self" and ce.attr in cls.locks:
            return ce.attr
        return None

    def _visit(self, node: ast.AST, held: FrozenSet[str], ctx) -> None:
        cls, relpath, lines, symbol = ctx
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = set(held)
            for item in node.items:
                la = self._lock_of_with_item(item.context_expr, cls)
                if la is None:
                    self._visit(item.context_expr, held, ctx)
                    continue
                q = cls.qual(la)
                self._edge_from_held(held, {q}, relpath,
                                     item.context_expr.lineno, symbol,
                                     lines)
                new.add(q)
            fheld = frozenset(new)
            for b in node.body:
                self._visit(b, fheld, ctx)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested function: runs later, with no lock held
            for b in node.body:
                self._visit(b, frozenset(), ctx)
            return
        if isinstance(node, ast.Lambda):
            self._visit(node.body, frozenset(), ctx)
            return
        if isinstance(node, ast.Call):
            self._check_call(node, held, ctx)
        elif isinstance(node, ast.Attribute):
            self._check_attr(node, held, ctx)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, ctx)

    def _check_attr(self, node: ast.Attribute, held: FrozenSet[str],
                    ctx) -> None:
        cls, relpath, lines, symbol = ctx
        if not (isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return
        lockattr = cls.guarded.get(node.attr)
        if lockattr is None:
            return
        if cls.qual(lockattr) not in held:
            self._report(
                "LOCK001", relpath, node.lineno,
                f"guarded attribute '{node.attr}' accessed without "
                f"holding self.{lockattr}", symbol, lines)

    def _is_blocking(self, path: Tuple[str, ...]) -> bool:
        for suf in NONBLOCKING_OVERRIDES:
            if path[-len(suf):] == suf:
                return False
        if len(path) >= 2 and path[-2] == "?":
            return False          # e.g. ", ".join(...) — literal base
        for suf in BLOCKING_SUFFIXES:
            if path[-len(suf):] == suf:
                return True
        return False

    def _check_call(self, node: ast.Call, held: FrozenSet[str],
                    ctx) -> None:
        cls, relpath, lines, symbol = ctx
        path = _dotted(node.func)

        # LOCK004: self.x_locked() without the lock
        if len(path) == 2 and path[0] == "self" \
                and path[1].endswith("_locked") \
                and path[1] in cls.methods and cls.primary_lock:
            if cls.qual(cls.primary_lock) not in held:
                self._report(
                    "LOCK004", relpath, node.lineno,
                    f"'{path[1]}' assumes self.{cls.primary_lock} is "
                    "held but the caller does not hold it",
                    symbol, lines)

        if not held:
            return
        held_s = ", ".join(sorted(held))

        # LOCK002: blocking call under a lock
        if self._is_blocking(path):
            self._report(
                "LOCK002", relpath, node.lineno,
                f"blocking call '{'.'.join(path)}' while holding "
                f"{held_s}", symbol, lines)
        elif path in NUMPY_SYNC_CALLS and self._args_produce_device(node):
            self._report(
                "LOCK002", relpath, node.lineno,
                f"'{'.'.join(path)}' forces a device->host sync while "
                f"holding {held_s}", symbol, lines)

        # lock-order edges from cross-class / declared-callable calls
        targets: Set[str] = set()
        if len(path) >= 2 and path[0] == "self":
            attr = path[1]
            if attr in cls.locks_of:
                targets |= set(cls.locks_of[attr])
            elif len(path) == 2 and attr in cls.methods:
                targets |= {cls.qual(la) for la in
                            cls.method_acquires.get(attr, ())}
            elif attr in cls.attr_types:
                for t in cls.attr_types[attr]:
                    targets |= self.may_acquire(t)
        self._edge_from_held(held, targets, relpath, node.lineno,
                             symbol, lines)

    @staticmethod
    def _args_produce_device(node: ast.Call) -> bool:
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for n in ast.walk(arg):
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in DEVICE_PRODUCING:
                    return True
        return False

    def _edge_from_held(self, held: FrozenSet[str], targets: Set[str],
                        relpath: str, line: int, symbol: str,
                        lines: List[str]) -> None:
        for t in targets:
            for h in held:
                if t == h:
                    if self.lock_kind.get(t) == "lock":
                        self._report(
                            "LOCK003", relpath, line,
                            f"re-acquiring non-reentrant lock {t} "
                            "already held (self-deadlock)",
                            symbol, lines)
                    continue    # RLock re-entry: no edge
                self.edges.add(h, t, relpath, line, symbol)

    # -- cycle detection over the accumulated edge graph ---------------------

    def report_cycles(self) -> None:
        graph = self.edges.graph
        seen_cycles: Set[Tuple[str, ...]] = set()

        def dfs(n: str, stack: List[str], on_stack: Set[str],
                done: Set[str]) -> None:
            on_stack.add(n)
            stack.append(n)
            for m in sorted(graph.get(n, ())):
                if m in on_stack:
                    cyc = stack[stack.index(m):] + [m]
                    base = cyc[:-1]
                    k = min(range(len(base)),
                            key=lambda i: base[i])
                    canon = tuple(base[k:] + base[:k])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        file, line, symbol = self.edges.site[
                            (cyc[0], cyc[1])]
                        self.findings.append(Finding(
                            rule="LOCK003", file=file, line=line,
                            message="lock-order cycle: "
                                    + " -> ".join(cyc),
                            symbol=symbol))
                elif m not in done:
                    dfs(m, stack, on_stack, done)
            stack.pop()
            on_stack.discard(n)
            done.add(n)

        done: Set[str] = set()
        for n in sorted(graph):
            if n not in done:
                dfs(n, [], set(), done)


def _parse(path: str) -> Tuple[Optional[ast.Module], List[str]]:
    with open(path) as f:
        src = f.read()
    try:
        return ast.parse(src, filename=path), src.splitlines()
    except SyntaxError:
        return None, src.splitlines()


def lint_paths(paths: Sequence[str],
               repo_root: Optional[str] = None) -> List[Finding]:
    """Run the lock lint over explicit files (two-phase: classes are
    collected from ALL given files before any is analyzed, so
    cross-file lock-order edges resolve)."""
    repo_root = repo_root or os.getcwd()
    parsed: List[Tuple[str, ast.Module, List[str]]] = []
    classes: Dict[str, ClassInfo] = {}
    for path in paths:
        tree, lines = _parse(path)
        if tree is None:
            continue
        rel = os.path.relpath(path, repo_root)
        parsed.append((rel, tree, lines))
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                classes.setdefault(node.name,
                                   _collect_class(node, rel))
    lock_kind = {c.qual(la): kind
                 for c in classes.values()
                 for la, kind in c.locks.items()}
    an = _Analyzer(classes, lock_kind)
    for rel, tree, lines in parsed:
        an.analyze_file(rel, tree, lines)
    an.report_cycles()
    an.findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return an.findings


def lint_tree(root: str,
              repo_root: Optional[str] = None) -> List[Finding]:
    """Run the lock lint over every ``*.py`` under ``root``."""
    files = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                files.append(os.path.join(dirpath, fn))
    return lint_paths(files, repo_root)
