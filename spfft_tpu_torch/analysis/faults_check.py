"""Fault-site registry checker.

The fault seam (:mod:`spfft_tpu_torch.faults`) is only as trustworthy as its
site names: a chaos script targeting ``store.lod`` silently injects
nothing, and a check site added without a ``SITES`` entry is invisible
to the harness's coverage accounting. This checker closes the loop —
every site name used at a check call must be declared exactly once in
``faults.SITES``, and every declared site must be checked somewhere.

What counts as a reference:

* a string-literal first argument of any ``check_site(`` /
  ``_check_fault(`` call (the unambiguous fault-seam entry points);
* a string-literal first argument of a ``.check(`` / ``._check(`` call
  when the literal is DOTTED (``store.spill``) or already a declared
  site — plain ``.check("x")`` calls on unrelated objects are ignored.

Checks:

1. site referenced at a check call but not declared in ``SITES`` ->
   error (waivable ``# faults: waived(reason)``);
2. site declared in ``SITES`` but never checked anywhere -> error at
   the declaration line (waivable);
3. duplicate declaration inside ``SITES`` -> error.

Variable (non-literal) site arguments — the seam plumbing itself, e.g.
``FaultPlan.check``'s forwarding — are skipped: the contract is on the
leaf call sites that name a subsystem.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from .core import Finding, ModuleInfo, PackageIndex

CHECKER = "fault-sites"

SPECS_NAME = "SITES"
SPECS_MODULE = "faults.py"
SITE_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)*$")
#: Call names that ALWAYS take a fault-site first argument.
STRICT_FUNCS = {"check_site", "_check_fault"}
#: Call names that take one only when the literal is dotted/declared.
LOOSE_FUNCS = {"check", "_check"}


def _call_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return ""


def _find_sites(index: PackageIndex):
    """The ``SITES`` tuple in faults.py: (module, ast node) or None."""
    for mod in index.modules.values():
        if mod.relpath != SPECS_MODULE:
            continue
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == SPECS_NAME
                            for t in stmt.targets) \
                    and isinstance(stmt.value, (ast.Tuple, ast.List)):
                return mod, stmt.value
    return None


def _parse_sites(mod: ModuleInfo, node,
                 findings: List[Finding]) -> Dict[str, int]:
    declared: Dict[str, int] = {}
    for elt in node.elts:
        if not (isinstance(elt, ast.Constant)
                and isinstance(elt.value, str)):
            findings.append(Finding(
                CHECKER, "error", mod.relpath, elt.lineno,
                f"non-literal entry in {SPECS_NAME} — site names must "
                f"be plain strings"))
            continue
        name = elt.value
        if name in declared:
            findings.append(Finding(
                CHECKER, "error", mod.relpath, elt.lineno,
                f"site {name!r} declared more than once in "
                f"{SPECS_NAME}"))
            continue
        declared[name] = elt.lineno
        if SITE_RE.match(name) is None:
            findings.append(Finding(
                CHECKER, "error", mod.relpath, elt.lineno,
                f"site {name!r} does not match the site grammar "
                f"(lowercase dotted words)"))
    return declared


def check(index: PackageIndex) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    sites = _find_sites(index)
    if sites is None:
        findings.append(Finding(
            CHECKER, "error", SPECS_MODULE, 1,
            f"no {SPECS_NAME} declaration found — every fault site "
            f"must be declared once in faults.py"))
        return findings, {}
    sites_mod, sites_node = sites
    declared = _parse_sites(sites_mod, sites_node, findings)

    # -- collect references --------------------------------------------------
    referenced: Dict[str, List[Tuple[str, int]]] = {}
    for mod in index.modules.values():
        if mod is sites_mod or mod.relpath.startswith("analysis/"):
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fname = _call_name(node)
            if fname not in STRICT_FUNCS and fname not in LOOSE_FUNCS:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue  # seam plumbing forwards a variable; skip
            name = first.value
            if fname in LOOSE_FUNCS and "." not in name \
                    and name not in declared:
                continue  # unrelated .check("...") call
            referenced.setdefault(name, []).append(
                (mod.relpath, node.lineno))

    # -- referenced but undeclared -------------------------------------------
    for name, where in sorted(referenced.items()):
        if name in declared:
            continue
        for relpath, lineno in where:
            mod = index.modules[relpath]
            stub = ast.Constant(value=name)
            stub.lineno = lineno
            stub.end_lineno = lineno
            reason = mod.waiver_for(stub, "faults")
            findings.append(Finding(
                CHECKER, "error", relpath, lineno,
                f"fault site {name!r} checked here but not declared "
                f"in faults.py {SPECS_NAME}",
                waived=reason is not None, reason=reason or ""))

    # -- declared but never checked ------------------------------------------
    for name, lineno in sorted(declared.items()):
        if name in referenced:
            continue
        stub = ast.Constant(value=name)
        stub.lineno = lineno
        stub.end_lineno = lineno
        reason = sites_mod.waiver_for(stub, "faults")
        findings.append(Finding(
            CHECKER, "error", sites_mod.relpath, lineno,
            f"fault site {name!r} declared in {SPECS_NAME} but no "
            f"check call ever targets it — dead coverage claim",
            waived=reason is not None, reason=reason or ""))

    extras = {"declared_sites": len(declared),
              "checked_sites": len(referenced)}
    return findings, extras
