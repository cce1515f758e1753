"""Error-taxonomy checker.

``errors.py`` mirrors the reference's exception hierarchy + C error
enum; this checker keeps that taxonomy real instead of decorative:

1. every exception class resolves a ``code`` (its own ``code =
   ErrorCode.X`` or an ancestor's, within the module), and every
   referenced ``ErrorCode`` member exists in the enum;
2. every exception class is USED — subclassed in-module, raised, or
   constructed somewhere in the package (``raise X(...)``,
   ``future.set_exception(X(...))``, ...). API-parity classes kept for
   mechanical migration from the reference enum carry an explicit
   ``# errors: waived(reason)`` on their ``class`` line, which the
   report lists;
3. every exception class has a row/mention in the docs (the taxonomy
   tables of the docs the run reads: the port's docs_torch/, or
   ``README.md`` and ``docs/`` under a given docs root) — an
   undocumented error type is a support ticket with no manual page.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ModuleInfo, PackageIndex, dotted

CHECKER = "error-taxonomy"

ENUM_BASES = {"IntEnum", "Enum", "enum.IntEnum", "enum.Enum"}


def _find_errors_module(index: PackageIndex) -> Optional[ModuleInfo]:
    for rel, mod in index.modules.items():
        if rel == "errors.py" or rel.endswith("/errors.py"):
            return mod
    return None


def _enum_members(mod: ModuleInfo) -> Dict[str, Set[str]]:
    """{enum class name: {member names}} for enum classes in the
    module."""
    out: Dict[str, Set[str]] = {}
    for stmt in mod.tree.body:
        if not isinstance(stmt, ast.ClassDef):
            continue
        bases = {dotted(b) for b in stmt.bases}
        if not (bases & ENUM_BASES):
            continue
        members: Set[str] = set()
        for sub in stmt.body:
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        members.add(tgt.id)
        out[stmt.name] = members
    return out


def _exception_classes(mod: ModuleInfo, enums: Dict[str, Set[str]]):
    """Exception classes of the module in definition order:
    [(node, bases-in-module)]."""
    names = set()
    out = []
    for stmt in mod.tree.body:
        if not isinstance(stmt, ast.ClassDef) or stmt.name in enums:
            continue
        bases = [dotted(b) for b in stmt.bases]
        in_module = [b for b in bases if b in names]
        is_exc = any(b in names or b in ("Exception", "BaseException")
                     for b in bases)
        if is_exc:
            names.add(stmt.name)
            out.append((stmt, in_module))
    return out


def _own_code(node: ast.ClassDef):
    """(ErrorCode member name, lineno) of a ``code = ErrorCode.X``
    class attribute, else None."""
    for stmt in node.body:
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "code":
                    name = dotted(stmt.value)
                    if name and "." in name:
                        return name.split(".", 1)[1], stmt.lineno
                    return (name or "?"), stmt.lineno
    return None


def _usage_sites(index: PackageIndex,
                 errors_mod: ModuleInfo) -> Set[str]:
    """Class names raised or constructed anywhere in the package
    outside the errors module itself (import statements don't count)."""
    used: Set[str] = set()
    for mod in index.modules.values():
        if mod is errors_mod:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Raise) and node.exc is not None:
                target = node.exc
                if isinstance(target, ast.Call):
                    target = target.func
                name = dotted(target)
                if name:
                    used.add(name.split(".")[-1])
            elif isinstance(node, ast.Call):
                name = dotted(node.func)
                if name:
                    used.add(name.split(".")[-1])
    return used


def _docs_text(docs_paths: List[str]) -> str:
    chunks = []
    for path in docs_paths:
        try:
            with open(path, "r", encoding="utf-8") as f:
                chunks.append(f.read())
        except OSError:
            continue
    return "\n".join(chunks)


def default_docs_paths(repo_root: str) -> List[str]:
    out = []
    readme = os.path.join(repo_root, "README.md")
    if os.path.exists(readme):
        out.append(readme)
    docs = os.path.join(repo_root, "docs")
    if os.path.isdir(docs):
        for fn in sorted(os.listdir(docs)):
            if fn.endswith(".md"):
                out.append(os.path.join(docs, fn))
    return out


def check(index: PackageIndex,
          docs_paths: Optional[List[str]] = None
          ) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    mod = _find_errors_module(index)
    if mod is None:
        findings.append(Finding(CHECKER, "error", "errors.py", 1,
                                "no errors.py module found"))
        return findings, {}
    enums = _enum_members(mod)
    classes = _exception_classes(mod, enums)
    if not classes:
        findings.append(Finding(CHECKER, "error", mod.relpath, 1,
                                "errors.py defines no exception "
                                "classes"))
        return findings, {}

    # 1 — code resolution through the in-module hierarchy
    codes: Dict[str, Optional[Tuple[str, int]]] = {}
    parent: Dict[str, List[str]] = {}
    for node, in_module_bases in classes:
        codes[node.name] = _own_code(node)
        parent[node.name] = in_module_bases

    def resolved_code(name: str, depth=0):
        if depth > 10:
            return None
        own = codes.get(name)
        if own is not None:
            return own
        for base in parent.get(name, ()):
            r = resolved_code(base, depth + 1)
            if r is not None:
                return r
        return None

    all_members = set()
    for members in enums.values():
        all_members |= members
    for node, _bases in classes:
        code = resolved_code(node.name)
        if code is None:
            findings.append(Finding(
                CHECKER, "error", mod.relpath, node.lineno,
                f"exception class {node.name} resolves no error code "
                f"(no `code = ErrorCode.X` on it or any ancestor)"))
        else:
            member, lineno = code
            if enums and member not in all_members:
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, lineno,
                    f"{node.name}.code references unknown ErrorCode "
                    f"member {member!r}"))

    # 2 — every class is used (raised/constructed/subclassed)
    used = _usage_sites(index, mod)
    subclassed = {b for _node, bases in classes for b in bases}
    for node, _bases in classes:
        if node.name in used or node.name in subclassed:
            continue
        reason = mod.waiver_for(node, "errors")
        findings.append(Finding(
            CHECKER, "error", mod.relpath, node.lineno,
            f"exception class {node.name} is never raised, "
            f"constructed or subclassed in the package",
            waived=reason is not None, reason=reason or ""))

    # 3 — documented in the taxonomy docs
    if docs_paths is not None:
        text = _docs_text(docs_paths)
        for node, _bases in classes:
            if re.search(r"\b%s\b" % re.escape(node.name), text):
                continue
            reason = mod.waiver_for(node, "errors")
            findings.append(Finding(
                CHECKER, "error", mod.relpath, node.lineno,
                f"exception class {node.name} has no row/mention in "
                f"the docs taxonomy",
                waived=reason is not None, reason=reason or ""))

    return findings, {"error_classes": len(classes)}
