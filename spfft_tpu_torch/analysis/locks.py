"""Lock-discipline + lock-acquisition-order checkers.

Two checks over the index:

1. **Guarded-field discipline** — a field declared ``#: guarded by
   <lock>`` may only be read or written inside ``with self.<lock>``
   (or a module-level ``with <lock>`` for guarded globals) in its own
   class/module. ``__init__``/``__new__`` are exempt (the object is not
   shared yet); a method annotated ``# lock: holds(<lock>)`` is assumed
   to run under the lock and every resolvable CALL of it is verified to
   actually hold it; ``# lock: waived(reason)`` suppresses one access
   and lands in the report's waiver list.

2. **Acquisition-order graph** — for every function the checker
   computes which known locks are held at each call site (lexically
   nested ``with`` blocks plus ``holds`` annotations), resolves calls
   through the index's receiver typing, propagates transitive
   acquisitions to a fixpoint, and records every "held A while
   acquiring B" edge. A cycle in that digraph is the deadlock shape a
   threaded dispatcher can actually hit, reported with one witness
   path per cycle. The edge list itself lands in the report's extras
   (``lock_order_edges``) — reviewable documentation of the real
   locking hierarchy.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import (ClassInfo, Finding, FunctionInfo, ModuleInfo,
                   PackageIndex, dotted)

CHECKER = "lock-discipline"
ORDER_CHECKER = "lock-order"

#: Ambiguous-name call resolution unions candidates only up to this
#: many; beyond it the call is skipped (a generic name like ``get``).
AMBIGUOUS_CAP = 3

#: Method names that collide with builtin-collection / stdlib-object
#: methods: calling one on an UNRESOLVED receiver is almost always a
#: dict/list/deque/thread/file operation, so the by-name fallback must
#: never union it onto a same-named class method (that is how a
#: ``self._store.get(...)`` dict read was once mis-read as
#: ``PlanRegistry.get`` and produced a phantom deadlock cycle). Typed
#: receivers resolve these names normally.
GENERIC_METHOD_NAMES = frozenset({
    "get", "set", "pop", "popitem", "append", "appendleft", "popleft",
    "extend", "extendleft", "update", "clear", "copy", "keys",
    "values", "items", "setdefault", "remove", "discard", "add",
    "insert", "sort", "reverse", "index", "count", "move_to_end",
    "join", "start", "run", "wait", "notify", "notify_all", "acquire",
    "release", "put", "read", "write", "flush", "close", "open",
    "send", "recv", "match", "search", "split", "strip", "load",
    "dump", "loads", "dumps", "encode", "decode", "format", "replace",
})

EXEMPT_METHODS = {"__init__", "__new__", "__del__"}


def _is_property(node) -> bool:
    for dec in node.decorator_list:
        name = dotted(dec)
        if name in ("property", "cached_property",
                    "functools.cached_property"):
            return True
    return False


def _with_locks(node, ci: Optional[ClassInfo],
                mod: ModuleInfo) -> Set[str]:
    """Lock names acquired by one ``with`` statement: ``self.<attr>``
    for known class lock fields, bare names for module locks."""
    out: Set[str] = set()
    for item in node.items:
        name = dotted(item.context_expr)
        if name is None:
            continue
        if name.startswith("self.") and ci is not None:
            attr = name.split(".", 1)[1]
            if "." not in attr:
                out.add(attr)
        elif name in mod.module_locks:
            out.add(name)
    return out


class _AccessVisitor(ast.NodeVisitor):
    """Walks one function body tracking the set of held lock names and
    recording guarded-field accesses made without the right lock."""

    def __init__(self, checker, mod: ModuleInfo,
                 ci: Optional[ClassInfo], fi: FunctionInfo):
        self.checker = checker
        self.mod = mod
        self.ci = ci
        self.fi = fi
        self.held: Set[str] = set()
        if fi.holds:
            self.held.add(fi.holds)
        #: (access node, enclosing statement, field, lock)
        self.violations: List[Tuple[ast.AST, ast.AST, str, str]] = []
        self._stmt_stack: List[ast.AST] = []
        #: (call node, frozenset(held lock ids)) for the order graph
        self.calls: List[Tuple[ast.Call, frozenset]] = []
        #: property reads of same-class @property methods:
        #: (method name, line, frozenset(held lock ids))
        self.property_reads: List[Tuple[str, int, frozenset]] = []
        #: every dotted attribute read: (receiver chain, attr, line,
        #: held) — the order graph maps reads on a __getattr__-bearing
        #: class (ServeConfig's knob reads) onto that method
        self.attr_reads: List[Tuple[str, str, int, frozenset]] = []
        #: with-acquisitions: (lock id, frozenset(held before))
        self.acquisitions: List[Tuple[str, frozenset]] = []

    # lock ids are package-unique strings: "ClassName._lock" scoped by
    # module, or "<module>:<name>" for module-level locks
    def _lock_id(self, name: str) -> str:
        if self.ci is not None and name in self.ci.lock_fields:
            return f"{self.ci.key}.{name}"
        if name in self.mod.module_locks:
            return f"{self.mod.relpath}::{name}"
        if self.ci is not None:
            return f"{self.ci.key}.{name}"
        return f"{self.mod.relpath}::{name}"

    def _held_ids(self) -> frozenset:
        return frozenset(self._lock_id(n) for n in self.held)

    def visit(self, node):
        if isinstance(node, ast.stmt):
            self._stmt_stack.append(node)
            try:
                super().visit(node)
            finally:
                self._stmt_stack.pop()
        else:
            super().visit(node)

    def _stmt(self) -> Optional[ast.AST]:
        return self._stmt_stack[-1] if self._stmt_stack else None

    def visit_With(self, node: ast.With):
        acquired = _with_locks(node, self.ci, self.mod)
        for name in acquired - self.held:
            self.acquisitions.append((self._lock_id(name),
                                      self._held_ids()))
        for item in node.items:
            self.visit(item.context_expr)
        before = set(self.held)
        self.held |= acquired
        for stmt in node.body:
            self.visit(stmt)
        self.held = before

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call):
        self.calls.append((node, self._held_ids()))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self" \
                and self.ci is not None:
            lock = self.ci.guarded.get(node.attr)
            if lock is not None and lock not in self.held:
                self.violations.append(
                    (node, self._stmt(), node.attr, f"self.{lock}"))
            fi = self.ci.methods.get(node.attr)
            if fi is not None and _is_property(fi.node):
                # a @property read runs the getter: the order graph
                # must see locks the getter takes (config-backed knob
                # properties read ServeConfig._lock)
                self.property_reads.append(
                    (node.attr, node.lineno, self._held_ids()))
        recv = dotted(node.value)
        if recv is not None:
            self.attr_reads.append((recv, node.attr, node.lineno,
                                    self._held_ids()))
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        lock = self.mod.guarded_globals.get(node.id)
        if lock is not None and lock not in self.held \
                and not isinstance(node.ctx, ast.Del):
            self.violations.append((node, self._stmt(), node.id, lock))

    # don't descend into nested defs/classes; they are visited as their
    # own functions (a nested function does NOT inherit the held set —
    # it usually runs on another thread)
    def visit_FunctionDef(self, node):
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return


def _iter_functions(index: PackageIndex):
    for mod in index.modules.values():
        for fi in mod.functions.values():
            yield mod, None, fi
        for ci in mod.classes.values():
            for fi in ci.methods.values():
                yield mod, ci, fi
        # nested defs inside functions (closures, thread targets) are
        # analysed as independent functions with no inherited locks
        seen = {id(fi.node) for fi in mod.functions.values()}
        for ci in mod.classes.values():
            seen |= {id(fi.node) for fi in ci.methods.values()}
        for owner_mod, owner_ci, owner_fi in list(
                _top_level(mod)):
            for sub in ast.walk(owner_fi.node):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)) \
                        and id(sub) not in seen:
                    seen.add(id(sub))
                    nested = FunctionInfo(
                        sub.name,
                        f"{owner_fi.qualname}.<{sub.name}>", sub,
                        None, owner_fi.class_name)
                    yield mod, owner_ci, nested


def _top_level(mod: ModuleInfo):
    for fi in mod.functions.values():
        yield mod, None, fi
    for ci in mod.classes.values():
        for fi in ci.methods.values():
            yield mod, ci, fi


def _resolve_call(index: PackageIndex, mod: ModuleInfo,
                  ci: Optional[ClassInfo], fi: FunctionInfo,
                  node: ast.Call,
                  local_types: Dict[str, str]) -> List[FunctionInfo]:
    name = dotted(node.func)
    if name is None:
        return []
    parts = name.split(".")
    # plain function call: same module, or imported function
    if len(parts) == 1:
        if parts[0] in mod.functions:
            return [mod.functions[parts[0]]]
        if parts[0] in mod.imported_names:
            src, orig = mod.imported_names[parts[0]]
            target = index._module_by_suffix(src)
            if target is not None and orig in target.functions:
                return [target.functions[orig]]
        return []
    recv, meth = ".".join(parts[:-1]), parts[-1]
    # module-function call through an alias: "_obs.record_compile"
    if len(parts) == 2 and parts[0] in mod.import_alias:
        target = index._module_by_suffix(mod.import_alias[parts[0]])
        if target is not None and meth in target.functions:
            return [target.functions[meth]]
    key = index.receiver_class(mod, ci, fi, recv, local_types)
    if key is not None:
        target_ci = index.classes.get(key)
        if target_ci is not None and meth in target_ci.methods:
            return [target_ci.methods[meth]]
        return []
    # unresolved receiver: fall back to by-name union when the method
    # name is rare enough to be meaningful
    if meth in GENERIC_METHOD_NAMES:
        return []
    candidates = index.methods_by_name.get(meth, [])
    candidates = [fi2 for _, fi2 in candidates
                  if fi2.class_name is not None]
    if 0 < len(candidates) <= AMBIGUOUS_CAP:
        return candidates
    return []


def check(index: PackageIndex) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    visitors: Dict[str, _AccessVisitor] = {}
    contexts: Dict[str, Tuple[ModuleInfo, Optional[ClassInfo],
                              FunctionInfo]] = {}
    for mod, ci, fi in _iter_functions(index):
        v = _AccessVisitor(CHECKER, mod, ci, fi)
        exempt = fi.name in EXEMPT_METHODS and ci is not None
        for stmt in fi.node.body:
            v.visit(stmt)
        visitors[fi.qualname] = v
        contexts[fi.qualname] = (mod, ci, fi)
        if fi.holds:
            continue  # body assumed under lock: discipline satisfied
        if exempt:
            continue
        for node, stmt, field, lock in v.violations:
            reason = mod.waiver_for(node, "lock")
            if reason is None and stmt is not None:
                # a standalone waiver on the line above the enclosing
                # STATEMENT covers accesses inside multi-line
                # conditions where a trailing comment cannot sit
                hit = mod.waivers_by_line.get(stmt.lineno - 1)
                if hit is not None and hit[0] == "lock":
                    reason = hit[1]
            findings.append(Finding(
                CHECKER, "error", mod.relpath, node.lineno,
                f"guarded field {field!r} accessed outside "
                f"`with {lock}` in {fi.qualname}",
                waived=reason is not None, reason=reason or ""))

    # holds() call-site verification: every resolvable call of a
    # holds-annotated method must be made while holding that lock
    holds_targets = {fi.qualname: (ci, fi)
                     for mod, ci, fi in _iter_functions(index)
                     if fi.holds and ci is not None}
    for qual, v in visitors.items():
        mod, ci, fi = contexts[qual]
        local = index.local_types(mod, fi)
        for node, held in v.calls:
            for target in _resolve_call(index, mod, ci, fi, node, local):
                if target.qualname not in holds_targets:
                    continue
                tci, tfi = holds_targets[target.qualname]
                need = f"{tci.key}.{tfi.holds}"
                if need in held:
                    continue
                reason = mod.waiver_for(node, "lock")
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, node.lineno,
                    f"{fi.qualname} calls {tfi.qualname} (annotated "
                    f"`lock: holds({tfi.holds})`) without holding "
                    f"{tfi.holds}",
                    waived=reason is not None, reason=reason or ""))

    order_findings, extras = _order_graph(index, visitors, contexts)
    findings.extend(order_findings)
    return findings, extras


# -- lock-acquisition order -------------------------------------------------

def _order_graph(index, visitors, contexts):
    """Edges "held A while acquiring B" (direct + call-transitive),
    then cycle detection."""
    # transitive acquisition sets per function (fixpoint)
    acquires: Dict[str, Set[str]] = {q: set() for q in visitors}
    callees: Dict[str, Set[str]] = {q: set() for q in visitors}
    call_edges: Dict[str, List[Tuple[str, frozenset, int]]] = \
        {q: [] for q in visitors}
    for qual, v in visitors.items():
        mod, ci, fi = contexts[qual]
        local = index.local_types(mod, fi)
        for lock, held in v.acquisitions:
            acquires[qual].add(lock)
        for node, held in v.calls:
            for target in _resolve_call(index, mod, ci, fi, node,
                                        local):
                if target.qualname in visitors:
                    callees[qual].add(target.qualname)
                    call_edges[qual].append(
                        (target.qualname, held, node.lineno))
        if ci is not None:
            for attr, line, held in v.property_reads:
                target = ci.methods.get(attr)
                if target is not None \
                        and target.qualname in visitors:
                    callees[qual].add(target.qualname)
                    call_edges[qual].append(
                        (target.qualname, held, line))
        for recv, attr, line, held in v.attr_reads:
            key = index.receiver_class(mod, ci, fi, recv, local)
            if key is None:
                continue
            target_ci = index.classes.get(key)
            if target_ci is None:
                continue
            target = target_ci.methods.get(attr)
            if target is not None and not _is_property(target.node):
                continue  # plain method reference, runs nothing
            if target is None and not attr.startswith("_"):
                # instance fields are underscore-named by project
                # convention (and ServeConfig.__getattr__ rejects
                # underscore names), so only public misses route to a
                # dynamic getter
                target = target_ci.methods.get("__getattr__")
            if target is not None and target.qualname in visitors:
                callees[qual].add(target.qualname)
                call_edges[qual].append((target.qualname, held, line))
    changed = True
    while changed:
        changed = False
        for qual in visitors:
            for callee in callees[qual]:
                extra = acquires[callee] - acquires[qual]
                if extra:
                    acquires[qual] |= extra
                    changed = True

    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for qual, v in visitors.items():
        mod, ci, fi = contexts[qual]
        for lock, held in v.acquisitions:
            for h in held:
                if h != lock:
                    edges.setdefault((h, lock), (mod.relpath,
                                                 fi.node.lineno))
        for callee, held, line in call_edges[qual]:
            for acquired in acquires[callee]:
                for h in held:
                    if h != acquired:
                        edges.setdefault((h, acquired),
                                         (mod.relpath, line))

    # cycle detection (DFS over the lock digraph)
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    findings: List[Finding] = []
    seen_cycles: Set[frozenset] = set()
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(node):
        color[node] = 1
        stack.append(node)
        for nxt in sorted(graph.get(node, ())):
            if color.get(nxt, 0) == 0:
                dfs(nxt)
            elif color.get(nxt) == 1:
                i = stack.index(nxt)
                cycle = stack[i:] + [nxt]
                key = frozenset(cycle)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    path, line = edges.get(
                        (cycle[0], cycle[1]), ("", 0))
                    findings.append(Finding(
                        ORDER_CHECKER, "error", path, line,
                        "lock acquisition-order cycle (deadlock "
                        "shape): " + " -> ".join(
                            _short(lk) for lk in cycle)))
        stack.pop()
        color[node] = 2

    for node in sorted(graph):
        if color.get(node, 0) == 0:
            dfs(node)

    extras = {"lock_order_edges": sorted(
        f"{_short(a)} -> {_short(b)} (at {p}:{ln})"
        for (a, b), (p, ln) in edges.items())}
    return findings, extras


def _short(lock_id: str) -> str:
    """Human-readable lock id: ClassName._lock / module.py::_lock."""
    if "::" in lock_id:
        mod, rest = lock_id.split("::", 1)
        if "." in rest and rest.split(".")[0][:1].isupper():
            return rest
        return f"{mod.rsplit('/', 1)[-1]}::{rest}"
    return lock_id
