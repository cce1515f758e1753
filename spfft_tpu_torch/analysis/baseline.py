"""Baseline lint: unused imports + undefined names (pyflakes-lite).

The dependency-free twin of the pyflakes-family ruff rules
(pyproject.toml), so the lint gate never degrades to a no-op on a
machine without ruff — the two implement the same two rule families:

* **unused-import** (F401): a name bound by ``import``/``from ...
  import`` and never referenced in the module — by a ``Name`` load, a
  string annotation, or an ``__all__`` entry. Imports in
  ``__init__.py`` files are treated as intentional re-exports (the
  ruff config mirrors this with a per-file ignore).
* **undefined-name** (F821): a ``Name`` load that resolves in no
  enclosing scope, the module scope (order-blind, deliberately more
  conservative than pyflakes) or builtins.

``# noqa`` on the offending line suppresses either, and findings
honour the shared ``# lint: waived(reason)`` annotation.
"""

from __future__ import annotations

import ast
import builtins
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ModuleInfo, PackageIndex

CHECKER = "baseline-lint"

_BUILTINS = set(dir(builtins)) | {
    "__file__", "__name__", "__doc__", "__package__", "__spec__",
    "__builtins__", "__debug__", "__loader__", "__path__",
    "__annotations__", "__dict__", "__class__", "WindowsError",
}


def _has_noqa(mod: ModuleInfo, line: int) -> bool:
    return any("noqa" in c for c in mod.comments.get(line, ()))


class _Scope:
    __slots__ = ("kind", "names", "globals_", "parent")

    def __init__(self, kind: str, parent: Optional["_Scope"]):
        self.kind = kind          # module | function | class | comp
        self.names: Set[str] = set()
        self.globals_: Set[str] = set()
        self.parent = parent


def _string_annotation_names(value: str) -> Set[str]:
    try:
        tree = ast.parse(value, mode="eval")
    except SyntaxError:
        return set()
    return {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}


class _ModuleLint(ast.NodeVisitor):
    """One pass collecting imports, bindings per scope and name loads;
    findings computed at the end."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.module_scope = _Scope("module", None)
        self.scope = self.module_scope
        #: import bindings: name -> (line, display) in MODULE scope
        self.imports: Dict[str, Tuple[int, str]] = {}
        #: every referenced name, module-wide (for unused-import)
        self.referenced: Set[str] = set()
        #: (name, line) loads to resolve against scopes
        self.loads: List[Tuple[str, int, _Scope]] = []
        self.findings: List[Finding] = []

    # -- bindings ------------------------------------------------------------
    def _bind(self, name: str) -> None:
        if name in self.scope.globals_:
            self.module_scope.names.add(name)
        else:
            self.scope.names.add(name)

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            self._bind(name)
            if self.scope is self.module_scope:
                self.imports.setdefault(
                    name, (node.lineno, alias.name))

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module == "__future__":
            return
        for alias in node.names:
            if alias.name == "*":
                # star import: give up on both rules for this module
                self.imports.clear()
                self.module_scope.names.add("*")
                continue
            name = alias.asname or alias.name
            self._bind(name)
            if self.scope is self.module_scope:
                self.imports.setdefault(
                    name, (node.lineno, alias.name))

    def visit_Global(self, node: ast.Global):
        self.scope.globals_.update(node.names)
        self.module_scope.names.update(node.names)

    def visit_Nonlocal(self, node: ast.Nonlocal):
        # treat as binding in current scope (resolution is lexical
        # anyway and we keep the checker conservative)
        self.scope.names.update(node.names)

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            self.referenced.add(node.id)
            self.loads.append((node.id, node.lineno, self.scope))
        else:
            self._bind(node.id)

    def visit_Attribute(self, node: ast.Attribute):
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if node.name:
            self._bind(node.name)
        self.generic_visit(node)

    def _visit_annotation(self, ann) -> None:
        if ann is None:
            return
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            names = _string_annotation_names(ann.value)
            self.referenced.update(names)
            for n in names:
                self.loads.append((n, ann.lineno, self.scope))
            return
        self.visit(ann)

    # -- scopes --------------------------------------------------------------
    def _function(self, node):
        self._bind(node.name)
        for dec in node.decorator_list:
            self.visit(dec)
        args = node.args
        for default in list(args.defaults) + \
                [d for d in args.kw_defaults if d is not None]:
            self.visit(default)
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            self._visit_annotation(a.annotation)
        self._visit_annotation(node.returns)
        outer = self.scope
        inner = _Scope("function", self._lexical_parent(outer))
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            inner.names.add(a.arg)
        self.scope = inner
        for stmt in node.body:
            self.visit(stmt)
        self.scope = outer

    def _lexical_parent(self, scope: _Scope) -> _Scope:
        """Class scopes are skipped by nested functions (Python scoping
        rule) — kept conservative: we keep the class scope in the chain
        to avoid false positives on idiomatic class-constant reads, but
        mark it so resolution order stays sane."""
        return scope

    visit_FunctionDef = _function
    visit_AsyncFunctionDef = _function

    def visit_Lambda(self, node: ast.Lambda):
        args = node.args
        for default in list(args.defaults) + \
                [d for d in args.kw_defaults if d is not None]:
            self.visit(default)
        outer = self.scope
        inner = _Scope("function", outer)
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            inner.names.add(a.arg)
        self.scope = inner
        self.visit(node.body)
        self.scope = outer

    def visit_ClassDef(self, node: ast.ClassDef):
        self._bind(node.name)
        for dec in node.decorator_list:
            self.visit(dec)
        for base in node.bases:
            self.visit(base)
        for kw in node.keywords:
            self.visit(kw.value)
        outer = self.scope
        self.scope = _Scope("class", outer)
        for stmt in node.body:
            self.visit(stmt)
        self.scope = outer

    def _comprehension(self, node):
        outer = self.scope
        self.scope = _Scope("comp", outer)
        for gen in node.generators:
            self.visit(gen.iter)
            self.visit(gen.target)
            for cond in gen.ifs:
                self.visit(cond)
        if isinstance(node, ast.DictComp):
            self.visit(node.key)
            self.visit(node.value)
        else:
            self.visit(node.elt)
        self.scope = outer

    visit_ListComp = _comprehension
    visit_SetComp = _comprehension
    visit_GeneratorExp = _comprehension
    visit_DictComp = _comprehension

    def visit_AnnAssign(self, node: ast.AnnAssign):
        self._visit_annotation(node.annotation)
        if node.value is not None:
            self.visit(node.value)
        self.visit(node.target)

    # -- results -------------------------------------------------------------
    def run(self) -> List[Finding]:
        tree = self.mod.tree
        for stmt in tree.body:
            self.visit(stmt)
        if "*" in self.module_scope.names:
            return self.findings  # star import: resolution is hopeless
        # __all__ entries count as references (re-export)
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in stmt.targets):
                for el in ast.walk(stmt.value):
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        self.referenced.add(el.value)
        is_init = self.mod.relpath.endswith("__init__.py")
        if not is_init:
            for name, (lineno, display) in sorted(
                    self.imports.items(), key=lambda kv: kv[1][0]):
                if name in self.referenced:
                    continue
                if _has_noqa(self.mod, lineno):
                    continue
                stub = ast.Constant(value=name)
                stub.lineno = lineno
                stub.end_lineno = lineno
                reason = self.mod.waiver_for(stub, "lint")
                self.findings.append(Finding(
                    CHECKER, "error", self.mod.relpath, lineno,
                    f"unused import: {display!r} (bound as {name!r})",
                    waived=reason is not None, reason=reason or ""))
        for name, lineno, scope in self.loads:
            if name in _BUILTINS:
                continue
            s: Optional[_Scope] = scope
            found = False
            while s is not None:
                if name in s.names:
                    found = True
                    break
                s = s.parent
            if not found and name in self.module_scope.names:
                found = True
            if found or _has_noqa(self.mod, lineno):
                continue
            stub = ast.Constant(value=name)
            stub.lineno = lineno
            stub.end_lineno = lineno
            reason = self.mod.waiver_for(stub, "lint")
            self.findings.append(Finding(
                CHECKER, "error", self.mod.relpath, lineno,
                f"undefined name: {name!r}",
                waived=reason is not None, reason=reason or ""))
        return self.findings


def check(index: PackageIndex) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    for mod in index.modules.values():
        findings.extend(_ModuleLint(mod).run())
    # de-duplicate repeated undefined-name hits per (file, name)
    seen: Set[Tuple[str, str]] = set()
    out: List[Finding] = []
    for f in findings:
        key = (f.path, f.message)
        if f.message.startswith("undefined name") and key in seen:
            continue
        seen.add(key)
        out.append(f)
    return out, {}
