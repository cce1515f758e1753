"""Event-kind registry checker.

Every structured journal event the package emits — a
``record_event("<kind>", **attrs)`` call — must name a kind declared
EXACTLY ONCE in ``obs/recorder.py``'s ``EVENT_SPECS``, with every
keyword attr inside the kind's declared key set; and every declared
kind must be emitted somewhere. The runtime journal drops undeclared
kinds/attrs silently (counted — it must never take down serving), so
this checker is where a typo'd kind or attr becomes a build failure
instead of a silently-empty flight recorder.

What counts as an emission: any call whose callee is literally named
``record_event`` (``obs.record_event``, ``_obs.record_event``, a bare
``record_event``, or a module-local wrapper's inner call — e.g.
``faults._journal``). Wrappers that forward a VARIABLE kind get a
warning, not an error (the registry can't see through them), waivable
like everything else with ``# events: waived(reason)``.

Checks:

1. emitted kind literal not declared -> error (waivable);
2. declared kind never emitted anywhere -> error;
3. emission keyword not in the kind's declared attr key set -> error;
4. duplicate kind keys / malformed specs (not a
   ``(category, help, (attr, ...))`` literal, kind not dotted
   ``category.name`` lowercase) -> error;
5. extra positional args on ``record_event`` (its signature is
   kind-only positional: attrs must be keywords) -> error.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from .core import Finding, ModuleInfo, PackageIndex

CHECKER = "event-registry"

KIND_RE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")
SPECS_NAME = "EVENT_SPECS"
EMIT_NAME = "record_event"


def _find_specs(index: PackageIndex):
    """The EVENT_SPECS dict literal: (module, ast.Dict) or None."""
    for mod in index.modules.values():
        for stmt in mod.tree.body:
            targets = []
            value = None
            if isinstance(stmt, ast.Assign):
                targets = [t for t in stmt.targets
                           if isinstance(t, ast.Name)]
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                targets = [stmt.target]
                value = stmt.value
            if any(t.id == SPECS_NAME for t in targets) \
                    and isinstance(value, ast.Dict):
                return mod, value
    return None


def _parse_specs(mod: ModuleInfo, node: ast.Dict,
                 findings: List[Finding]
                 ) -> Dict[str, Tuple[Set[str], int]]:
    """kind -> (declared attr keys, lineno); malformed specs are
    reported and still registered (one finding, not a cascade)."""
    declared: Dict[str, Tuple[Set[str], int]] = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant)
                and isinstance(k.value, str)):
            findings.append(Finding(
                CHECKER, "error", mod.relpath,
                getattr(k, "lineno", node.lineno),
                f"non-literal key in {SPECS_NAME} (kinds must be "
                f"string literals the checker can read)"))
            continue
        kind = k.value
        if kind in declared:
            findings.append(Finding(
                CHECKER, "error", mod.relpath, k.lineno,
                f"event kind {kind!r} declared more than once in "
                f"{SPECS_NAME}"))
            continue
        if not KIND_RE.match(kind):
            findings.append(Finding(
                CHECKER, "error", mod.relpath, k.lineno,
                f"event kind {kind!r} is not dotted lowercase "
                f"'category.name'"))
        attrs: Set[str] = set()
        ok = (isinstance(v, (ast.Tuple, ast.List)) and len(v.elts) == 3
              and isinstance(v.elts[0], ast.Constant)
              and isinstance(v.elts[0].value, str)
              and isinstance(v.elts[1], ast.Constant)
              and isinstance(v.elts[1].value, str)
              and isinstance(v.elts[2], (ast.Tuple, ast.List)))
        if ok:
            for a in v.elts[2].elts:
                if isinstance(a, ast.Constant) \
                        and isinstance(a.value, str):
                    attrs.add(a.value)
                else:
                    ok = False
        if not ok:
            findings.append(Finding(
                CHECKER, "error", mod.relpath, k.lineno,
                f"event kind {kind!r} spec is not a literal "
                f"(category, help, (attr, ...)) tuple"))
        elif not re.match(r"^[a-z][a-z0-9_]*$", v.elts[0].value):
            # the category is the owning SUBSYSTEM (control, serve,
            # cluster, ...), deliberately not the dotted prefix — one
            # subsystem owns several event nouns
            findings.append(Finding(
                CHECKER, "error", mod.relpath, k.lineno,
                f"event kind {kind!r} category "
                f"{v.elts[0].value!r} is not a lowercase identifier"))
        declared[kind] = (attrs, k.lineno)
    return declared


def _is_emit_call(node: ast.Call) -> bool:
    func = node.func
    if isinstance(func, ast.Name):
        return func.id == EMIT_NAME
    if isinstance(func, ast.Attribute):
        return func.attr == EMIT_NAME
    return False


def check(index: PackageIndex) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    specs = _find_specs(index)
    if specs is None:
        findings.append(Finding(
            CHECKER, "error", "obs/recorder.py", 1,
            f"no {SPECS_NAME} declaration found — every journal event "
            f"kind must be declared once in obs/recorder.py"))
        return findings, {}
    specs_mod, specs_node = specs
    declared = _parse_specs(specs_mod, specs_node, findings)

    emitted: Set[str] = set()
    emissions = 0
    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and _is_emit_call(node)):
                continue
            # skip the definition module's own journal plumbing is NOT
            # needed: recorder.py's internal emissions (incident
            # capture outcomes) are real events like any other
            emissions += 1
            reason = mod.waiver_for(node, "events")
            if len(node.args) > 1:
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, node.lineno,
                    f"{EMIT_NAME} takes one positional arg (the "
                    f"kind); attrs must be keywords",
                    waived=reason is not None, reason=reason or ""))
            first = node.args[0] if node.args else None
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                findings.append(Finding(
                    CHECKER, "warning", mod.relpath, node.lineno,
                    f"{EMIT_NAME} called with a non-literal kind — "
                    f"the registry cannot verify it statically",
                    waived=reason is not None, reason=reason or ""))
                continue
            kind = first.value
            emitted.add(kind)
            info = declared.get(kind)
            if info is None:
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, node.lineno,
                    f"event kind {kind!r} emitted here but not "
                    f"declared in obs/recorder.py {SPECS_NAME}",
                    waived=reason is not None, reason=reason or ""))
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue  # **splat: runtime filtering covers it
                if kw.arg not in info[0]:
                    findings.append(Finding(
                        CHECKER, "error", mod.relpath, node.lineno,
                        f"event {kind!r} emitted with undeclared attr "
                        f"{kw.arg!r} (declared: "
                        f"{sorted(info[0])})",
                        waived=reason is not None, reason=reason or ""))

    for kind, (_, lineno) in sorted(declared.items()):
        if kind in emitted:
            continue
        stub = ast.Constant(value=kind)
        stub.lineno = lineno
        stub.end_lineno = lineno
        reason = specs_mod.waiver_for(stub, "events")
        findings.append(Finding(
            CHECKER, "error", specs_mod.relpath, lineno,
            f"event kind {kind!r} declared in {SPECS_NAME} but "
            f"never emitted by any {EMIT_NAME} call",
            waived=reason is not None, reason=reason or ""))

    extras = {"declared_event_kinds": len(declared),
              "event_emission_sites": emissions}
    return findings, extras
