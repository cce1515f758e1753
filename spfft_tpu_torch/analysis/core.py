"""Shared module-indexing core of the port's project lint engine (the
port's copy of ``spfft_tpu/analysis/core.py``).

The reference library leans on compiler-enforced invariants (typed
views, ``disjoint`` aliasing checks — the L0 memory layer); a Python
package has none of that, so the contracts the code claims in comments
and docstrings — "mutated only under the executor's pool lock", "every
span closed on all failure paths", "counter names declared once" — are
machine-checked annotations here: every checker (:mod:`locks`,
:mod:`spans`, :mod:`counters_check`, :mod:`errors_check`, :mod:`knobs`,
:mod:`baseline`, ...) runs over the ONE index built here, so the
package is parsed exactly once per analysis run.

Annotation grammar (comments, parsed with :mod:`tokenize` so they carry
exact line numbers):

``#: guarded by <lock>``
    On (or on the line above) the first ``self.<field> = ...``
    assignment: every read/write of ``<field>`` in that class must sit
    inside ``with self.<lock>``. On a module-level assignment the lock
    is a module-level lock object.
``# lock: waived(<reason>)``
    Trailing on an access line (or standalone on the line above the
    statement): suppresses the lock-discipline finding; the report
    lists every waiver with its reason.
``# lock: holds(<lock>)``
    On a ``def`` line: the body is assumed to hold ``<lock>`` (the
    "_locked-suffix helper" idiom); the checker instead verifies every
    resolvable CALL of the method is made while holding it.
``# span: closed-by(<Qualname>)``
    On a span-open line: closure happens cross-function in
    ``<Qualname>`` (``Class.method`` or a function name), which must
    exist and contain a close call.
``# trace: boundary(<param>)``
    On a ``def`` line: the function is a cluster RPC boundary whose
    ``<param>`` carries the propagated trace context (see
    :mod:`.trace_check` for the three rules this enables).
``# span: waived(<reason>)`` / ``# counters: waived(...)`` /
``# errors: waived(...)`` / ``# knobs: waived(...)`` /
``# trace: waived(...)``
    Per-checker escape hatches, all listed in the report.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: Annotation comment patterns.
GUARD_RE = re.compile(r"#:\s*guarded by\s+([A-Za-z_][A-Za-z0-9_]*)")
WAIVE_RE = re.compile(
    r"#\s*(lock|span|counters|errors|knobs|lint|faults|trace|events)"
    r"\s*:\s*waived\(([^)]*)\)")
HOLDS_RE = re.compile(
    r"#\s*lock\s*:\s*holds\(([A-Za-z_][A-Za-z0-9_]*)\)")
CLOSED_BY_RE = re.compile(r"#\s*span\s*:\s*closed-by\(([^)]+)\)")

#: Constructors whose result is a lock-like object (``with`` works and
#: mutual exclusion is the point).
LOCK_FACTORIES = {"Lock", "RLock", "Condition"}


class Finding:
    """One checker result. ``severity`` is ``error`` (nonzero exit) or
    ``warning``; a waived finding is demoted to the report's waiver
    list instead."""

    __slots__ = ("checker", "severity", "path", "line", "message",
                 "waived", "reason")

    def __init__(self, checker: str, severity: str, path: str,
                 line: int, message: str, waived: bool = False,
                 reason: str = ""):
        self.checker = checker
        self.severity = severity
        self.path = path
        self.line = line
        self.message = message
        self.waived = waived
        self.reason = reason

    def to_dict(self) -> dict:
        d = {"checker": self.checker, "severity": self.severity,
             "path": self.path, "line": self.line,
             "message": self.message}
        if self.waived:
            d["waived"] = True
            d["reason"] = self.reason
        return d

    def __repr__(self):  # pragma: no cover - debugging aid
        w = " [waived]" if self.waived else ""
        return (f"{self.path}:{self.line}: [{self.checker}] "
                f"{self.message}{w}")


class FunctionInfo:
    """One function/method: AST node, qualname, def-line annotations."""

    __slots__ = ("name", "qualname", "node", "holds", "class_name")

    def __init__(self, name: str, qualname: str, node,
                 holds: Optional[str], class_name: Optional[str]):
        self.name = name
        self.qualname = qualname
        self.node = node
        self.holds = holds
        self.class_name = class_name


class ClassInfo:
    """One class: methods, lock fields, guarded-field declarations and
    inferred field types."""

    __slots__ = ("name", "key", "node", "methods", "lock_fields",
                 "guarded", "field_types", "bases")

    def __init__(self, name: str, key: str, node):
        self.name = name
        self.key = key            # "<relpath>::<ClassName>"
        self.node = node
        self.methods: Dict[str, FunctionInfo] = {}
        self.lock_fields: Set[str] = set()
        self.guarded: Dict[str, str] = {}       # field -> lock attr
        self.field_types: Dict[str, str] = {}   # field -> class key
        self.bases: List[str] = []


class ModuleInfo:
    """One parsed module plus its comment map and annotations."""

    __slots__ = ("path", "relpath", "source", "tree", "comments",
                 "classes", "functions", "module_locks",
                 "guarded_globals", "instance_types", "import_alias",
                 "imported_names", "waivers_by_line", "closed_by_line",
                 "class_aliases", "standalone_comment_lines")

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source)
        self.comments: Dict[int, List[str]] = {}
        self.standalone_comment_lines: set = set()
        self._collect_comments()
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.module_locks: Set[str] = set()
        self.guarded_globals: Dict[str, str] = {}
        #: module-level ``NAME = ClassName(...)`` instances -> class key
        self.instance_types: Dict[str, str] = {}
        #: ``import x.y as z`` / ``from . import obs as _obs``
        self.import_alias: Dict[str, str] = {}
        #: ``from .m import NAME [as A]`` -> (module, original name)
        self.imported_names: Dict[str, Tuple[str, str]] = {}
        #: ``from .m import ClassName`` resolved to class keys later
        self.class_aliases: Dict[str, str] = {}
        self.waivers_by_line: Dict[int, Tuple[str, str]] = {}
        self.closed_by_line: Dict[int, str] = {}
        self._collect_annotation_lines()

    def _collect_comments(self) -> None:
        lines = self.source.splitlines()
        try:
            toks = tokenize.generate_tokens(
                io.StringIO(self.source).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    line = tok.start[0]
                    self.comments.setdefault(line, []).append(
                        tok.string)
                    text = (lines[line - 1] if line <= len(lines)
                            else "")
                    if text.lstrip().startswith("#"):
                        self.standalone_comment_lines.add(line)
        except tokenize.TokenError:  # pragma: no cover
            pass

    def _collect_annotation_lines(self) -> None:
        for line, texts in self.comments.items():
            for text in texts:
                m = WAIVE_RE.search(text)
                if m:
                    self.waivers_by_line[line] = (m.group(1),
                                                  m.group(2).strip())
                m = CLOSED_BY_RE.search(text)
                if m:
                    self.closed_by_line[line] = m.group(1).strip()

    # -- comment lookups ----------------------------------------------------
    def comment_match(self, regex, line: int) -> Optional[re.Match]:
        for text in self.comments.get(line, ()):
            m = regex.search(text)
            if m:
                return m
        return None

    def statement_annotation(self, node, table: Dict[int, Tuple],
                             kind: Optional[str] = None):
        """Annotation covering ``node``'s statement: a trailing comment
        on any line the statement spans, or a STANDALONE comment on the
        line directly above it (a trailing comment on the previous
        statement never leaks onto this one)."""
        end = getattr(node, "end_lineno", node.lineno)
        for line in range(node.lineno, end + 1):
            hit = table.get(line)
            if hit is not None and (kind is None or hit[0] == kind):
                return hit
        if node.lineno - 1 in self.standalone_comment_lines:
            hit = table.get(node.lineno - 1)
            if hit is not None and (kind is None or hit[0] == kind):
                return hit
        return None

    def waiver_for(self, node, checker: str) -> Optional[str]:
        hit = self.statement_annotation(node, self.waivers_by_line,
                                        checker)
        return hit[1] if hit is not None else None

    def closed_by_for(self, node) -> Optional[str]:
        end = getattr(node, "end_lineno", node.lineno)
        for line in range(node.lineno, end + 1):
            if line in self.closed_by_line:
                return self.closed_by_line[line]
        if node.lineno - 1 in self.standalone_comment_lines:
            return self.closed_by_line.get(node.lineno - 1)
        return None

    def guard_decl_for(self, node) -> Optional[str]:
        end = getattr(node, "end_lineno", node.lineno)
        lines = list(range(node.lineno, end + 1))
        if node.lineno - 1 in self.standalone_comment_lines:
            lines.append(node.lineno - 1)
        for line in lines:
            m = self.comment_match(GUARD_RE, line)
            if m:
                return m.group(1)
        return None


def dotted(node) -> Optional[str]:
    """``a.b.c`` attribute/name chain as a string, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node) -> Optional[str]:
    """Dotted name of a call's callee, else None."""
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return None


def _is_lock_ctor(node) -> bool:
    name = call_name(node)
    if name is None:
        return False
    last = name.split(".")[-1]
    return last in LOCK_FACTORIES


class PackageIndex:
    """The parsed package: every module, class, function, lock and
    annotation — built once, consumed by every checker."""

    def __init__(self, modules: Dict[str, ModuleInfo]):
        self.modules = modules
        #: class key -> ClassInfo
        self.classes: Dict[str, ClassInfo] = {}
        #: bare class name -> [class keys] (ambiguity-aware resolution)
        self.class_names: Dict[str, List[str]] = {}
        #: bare method name -> [(class key, FunctionInfo)]
        self.methods_by_name: Dict[str, List[Tuple[str, FunctionInfo]]] \
            = {}
        for mod in modules.values():
            self._index_module(mod)
        for mod in modules.values():
            self._resolve_imports(mod)
            self._infer_field_types(mod)

    # -- construction -------------------------------------------------------
    def _index_module(self, mod: ModuleInfo) -> None:
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.ClassDef):
                self._index_class(mod, stmt)
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                fi = self._make_function(mod, stmt, None)
                mod.functions[stmt.name] = fi
            elif isinstance(stmt, ast.Assign):
                self._index_module_assign(mod, stmt)
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                name = stmt.target.id
                if stmt.value is not None \
                        and _is_lock_ctor(stmt.value):
                    mod.module_locks.add(name)
                lock = mod.guard_decl_for(stmt)
                if lock is not None:
                    mod.guarded_globals[name] = lock
            elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
                self._index_import(mod, stmt)

    def _index_import(self, mod: ModuleInfo, stmt) -> None:
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                mod.import_alias[alias.asname or
                                 alias.name.split(".")[0]] = alias.name
            return
        base = "." * stmt.level + (stmt.module or "")
        for alias in stmt.names:
            name = alias.asname or alias.name
            mod.imported_names[name] = (base, alias.name)

    def _index_module_assign(self, mod: ModuleInfo, stmt: ast.Assign):
        for tgt in stmt.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if _is_lock_ctor(stmt.value):
                mod.module_locks.add(tgt.id)
            cname = call_name(stmt.value)
            if cname is not None:
                mod.instance_types.setdefault(tgt.id, cname)
            lock = mod.guard_decl_for(stmt)
            if lock is not None:
                mod.guarded_globals[tgt.id] = lock
        # AnnAssign module globals handled via ast.AnnAssign walk below

    def _make_function(self, mod: ModuleInfo, node,
                       class_name: Optional[str]) -> FunctionInfo:
        qual = (f"{class_name}.{node.name}" if class_name
                else node.name)
        holds = None
        end = getattr(node, "end_lineno", node.lineno)
        # a holds() annotation on the def line, the line above, or any
        # line of the (possibly multi-line) signature
        sig_end = node.body[0].lineno - 1 if node.body else end
        lines = list(range(node.lineno, sig_end + 1))
        if node.lineno - 1 in mod.standalone_comment_lines:
            lines.insert(0, node.lineno - 1)
        for line in lines:
            m = mod.comment_match(HOLDS_RE, line)
            if m:
                holds = m.group(1)
                break
        fi = FunctionInfo(node.name, f"{mod.relpath}::{qual}", node,
                          holds, class_name)
        key = (f"{mod.relpath}::{class_name}" if class_name else None)
        self.methods_by_name.setdefault(node.name, []).append(
            (key or mod.relpath, fi))
        return fi

    def _index_class(self, mod: ModuleInfo, node: ast.ClassDef) -> None:
        key = f"{mod.relpath}::{node.name}"
        ci = ClassInfo(node.name, key, node)
        ci.bases = [dotted(b) for b in node.bases
                    if dotted(b) is not None]
        mod.classes[node.name] = ci
        self.classes[key] = ci
        self.class_names.setdefault(node.name, []).append(key)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[stmt.name] = self._make_function(
                    mod, stmt, node.name)
        # guarded/lock fields: scan every self.<f> = ... in every method
        for fi in ci.methods.values():
            for sub in ast.walk(fi.node):
                if isinstance(sub, ast.Assign):
                    targets = sub.targets
                    value = sub.value
                elif isinstance(sub, ast.AnnAssign) \
                        and sub.value is not None:
                    targets = [sub.target]
                    value = sub.value
                else:
                    continue
                for tgt in targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    if _is_lock_ctor(value):
                        ci.lock_fields.add(tgt.attr)
                    lock = mod.guard_decl_for(sub)
                    if lock is not None:
                        ci.guarded.setdefault(tgt.attr, lock)

    # -- import/name resolution --------------------------------------------
    def _module_by_suffix(self, name: str) -> Optional[ModuleInfo]:
        """Resolve a dotted/relative module reference to an indexed
        module by path-suffix matching (the index is rooted at one
        package, so suffixes are unambiguous in practice)."""
        name = name.lstrip(".")
        if not name:
            return None
        tail = name.replace(".", "/")
        for rel, mod in self.modules.items():
            stem = rel[:-3] if rel.endswith(".py") else rel
            if stem.endswith("/__init__"):
                stem = stem[:-len("/__init__")]
            if stem == tail or stem.endswith("/" + tail):
                return mod
        return None

    def _resolve_imports(self, mod: ModuleInfo) -> None:
        """Resolve ``from x import Name`` to class keys / instance
        types, following re-exports up to a few hops."""
        for name, (src, orig) in mod.imported_names.items():
            target = self._module_by_suffix(src)
            seen = 0
            while target is not None and seen < 4:
                if orig in target.classes:
                    mod.class_aliases[name] = target.classes[orig].key
                    break
                if orig in target.instance_types:
                    mod.instance_types.setdefault(
                        name, target.instance_types[orig])
                    # class name may need that module's context; store
                    # origin module alongside via a synthetic alias
                    mod.class_aliases.setdefault(
                        "~origin~" + name, target.relpath)
                    break
                if orig in target.imported_names:
                    src2, orig = target.imported_names[orig]
                    target = self._module_by_suffix(src2)
                    seen += 1
                    continue
                break

    def resolve_class(self, mod: ModuleInfo,
                      name: Optional[str]) -> Optional[str]:
        """Class key for a (possibly dotted) class reference as seen
        from ``mod``; None when unknown/ambiguous."""
        if not name:
            return None
        last = name.split(".")[-1]
        if last in mod.classes:
            return mod.classes[last].key
        if last in mod.class_aliases:
            return mod.class_aliases[last]
        keys = self.class_names.get(last)
        if keys and len(keys) == 1:
            return keys[0]
        return None

    def _infer_field_types(self, mod: ModuleInfo) -> None:
        """``self.f = ClassName(...)`` / annotated parameters /
        ``ClassName.classmethod()`` results -> field class keys."""
        for ci in mod.classes.values():
            for fi in ci.methods.values():
                params: Dict[str, Optional[str]] = {}
                args = fi.node.args
                for a in list(args.posonlyargs) + list(args.args) \
                        + list(args.kwonlyargs):
                    params[a.arg] = self._annotation_class(
                        mod, a.annotation)
                for sub in ast.walk(fi.node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    for tgt in sub.targets:
                        if not (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            continue
                        key = self._value_class(mod, sub.value, params)
                        if key is not None:
                            ci.field_types.setdefault(tgt.attr, key)
        # module-level instances: resolve the recorded ctor names
        resolved = {}
        for name, ctor in mod.instance_types.items():
            origin = mod.class_aliases.get("~origin~" + name)
            key = None
            if origin is not None:
                key = self.resolve_class(self.modules[origin], ctor)
            if key is None:
                key = self.resolve_class(mod, ctor)
            if key is not None:
                resolved[name] = key
        mod.instance_types = resolved

    def _annotation_class(self, mod: ModuleInfo,
                          ann) -> Optional[str]:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return self.resolve_class(mod, ann.value.split("[")[0])
        if isinstance(ann, ast.Subscript):
            # Optional[X] / "Optional[X]"
            return self._annotation_class(mod, ann.slice)
        name = dotted(ann)
        return self.resolve_class(mod, name)

    def _value_class(self, mod: ModuleInfo, value,
                     params: Dict[str, Optional[str]],
                     cls_key: Optional[str] = None) -> Optional[str]:
        if isinstance(value, ast.IfExp):
            return (self._value_class(mod, value.body, params, cls_key)
                    or self._value_class(mod, value.orelse, params,
                                         cls_key))
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                key = self._value_class(mod, v, params, cls_key)
                if key is not None:
                    return key
        if isinstance(value, ast.Name):
            return params.get(value.id)
        cname = call_name(value)
        if cname is None:
            return None
        if cname == "cls" and cls_key is not None:
            return cls_key
        key = self.resolve_class(mod, cname)
        if key is not None:
            return key
        # ClassName.classmethod() -> ClassName
        parts = cname.split(".")
        if len(parts) >= 2:
            owner = self.resolve_class(mod, ".".join(parts[:-1]))
            if owner is not None and parts[-1] in \
                    self.classes[owner].methods:
                return owner
        return None

    # -- generic receiver typing (used by locks/spans) ----------------------
    def receiver_class(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                       fi: FunctionInfo, recv: str,
                       local_types: Dict[str, str]) -> Optional[str]:
        """Class key of a dotted receiver expression, best-effort."""
        parts = recv.split(".")
        if parts[0] in ("self", "cls") and ci is not None:
            if len(parts) == 1:
                return ci.key
            if len(parts) == 2:
                return ci.field_types.get(parts[1])
            return None
        if len(parts) == 1:
            if parts[0] in local_types:
                return local_types[parts[0]]
            if parts[0] in mod.instance_types:
                return mod.instance_types[parts[0]]
            return None
        # module alias / imported module attribute: "mod.NAME"
        head, rest = parts[0], parts[1:]
        target = None
        if head in mod.import_alias:
            target = self._module_by_suffix(mod.import_alias[head])
        elif head in mod.imported_names:
            src, orig = mod.imported_names[head]
            target = self._module_by_suffix(
                src + "." + orig if src.endswith(".") else
                (src + "." + orig if src else orig))
            if target is None:
                target = self._module_by_suffix(src)
        if target is not None and len(rest) == 1:
            return target.instance_types.get(rest[0])
        return None

    def local_types(self, mod: ModuleInfo,
                    fi: FunctionInfo) -> Dict[str, str]:
        """Simple intra-function inference: ``x = ClassName(...)`` and
        ``x = self.field`` local variable types."""
        out: Dict[str, str] = {}
        ci = (mod.classes.get(fi.class_name)
              if fi.class_name else None)
        params: Dict[str, Optional[str]] = {}
        args = fi.node.args
        for a in list(args.posonlyargs) + list(args.args) \
                + list(args.kwonlyargs):
            key = self._annotation_class(mod, a.annotation)
            if key is not None:
                params[a.arg] = key
        out.update({k: v for k, v in params.items() if v})
        cls_key = ci.key if ci is not None else None
        for sub in ast.walk(fi.node):
            if not isinstance(sub, ast.Assign):
                continue
            for tgt in sub.targets:
                if not isinstance(tgt, ast.Name):
                    continue
                key = self._value_class(mod, sub.value, params,
                                        cls_key)
                if key is None and ci is not None:
                    val = dotted(sub.value)
                    if val and val.startswith("self.") \
                            and val.count(".") == 1:
                        key = ci.field_types.get(val.split(".")[1])
                if key is not None:
                    out.setdefault(tgt.id, key)
        return out


# -- package loading --------------------------------------------------------

DEFAULT_EXCLUDES = ("analysis/fixtures",)


def iter_py_files(root: str) -> Iterable[Tuple[str, str]]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__",)]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                if any(rel.startswith(e) for e in DEFAULT_EXCLUDES):
                    continue
                yield path, rel


def index_package(root: str) -> PackageIndex:
    """Parse every ``.py`` under ``root`` (a package directory) into
    one :class:`PackageIndex`."""
    modules: Dict[str, ModuleInfo] = {}
    for path, rel in iter_py_files(root):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        modules[rel] = ModuleInfo(path, rel, source)
    return PackageIndex(modules)


def index_sources(sources: Dict[str, str]) -> PackageIndex:
    """Index in-memory sources ``{relpath: source}`` — the fixture-test
    entry point."""
    return PackageIndex({rel: ModuleInfo(rel, rel, src)
                         for rel, src in sources.items()})


# -- report -----------------------------------------------------------------

class Report:
    """All findings + waivers of one analysis run."""

    def __init__(self):
        self.findings: List[Finding] = []
        self.checkers_run: List[str] = []
        self.extras: Dict[str, object] = {}

    def extend(self, checker: str, findings: Iterable[Finding]) -> None:
        self.checkers_run.append(checker)
        self.findings.extend(findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings
                if not f.waived and f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings
                if not f.waived and f.severity == "warning"]

    @property
    def waivers(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> dict:
        return {
            "ok": self.ok(),
            "checkers": self.checkers_run,
            "summary": {"errors": len(self.errors),
                        "warnings": len(self.warnings),
                        "waivers": len(self.waivers)},
            "findings": [f.to_dict() for f in self.findings
                         if not f.waived],
            "waivers": [f.to_dict() for f in self.waivers],
            "extras": self.extras,
        }

    def to_json(self, indent=2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    def text(self) -> str:
        lines = []
        for f in sorted(self.findings,
                        key=lambda f: (f.waived, f.path, f.line)):
            if f.waived:
                continue
            lines.append(f"{f.path}:{f.line}: {f.severity}: "
                         f"[{f.checker}] {f.message}")
        if self.waivers:
            lines.append("")
            lines.append(f"waivers ({len(self.waivers)}):")
            for f in sorted(self.waivers,
                            key=lambda f: (f.path, f.line)):
                lines.append(f"  {f.path}:{f.line}: [{f.checker}] "
                             f"{f.message} — waived: {f.reason}")
        lines.append("")
        lines.append(f"{len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s), "
                     f"{len(self.waivers)} waiver(s) "
                     f"[{', '.join(self.checkers_run)}]")
        return "\n".join(lines)
