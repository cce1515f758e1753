"""Counter/series registry checker.

Every ``spfft_*`` Prometheus series the package emits must be declared
EXACTLY ONCE in ``obs/counters.py``'s ``METRIC_SPECS`` and be
surfaceable by ``obs.prometheus_text`` — a typo'd counter name becomes
a lint error here instead of a silently-new series on the scrape
endpoint.

What counts as a reference:

* a string-literal first argument of any ``.inc(`` / ``.set(`` /
  ``.get(`` call (the ``Counters`` recording surface);
* any other non-docstring string literal that *looks like* a metric
  name (``spfft_<...>`` — the ``record_store`` event->name dict is the
  motivating case). Package identifiers starting ``spfft_tpu`` are
  excluded, and so are the C entry names of the port's kernel
  libraries: the symbol passed to ``_build.function(source, symbol,
  ...)`` and to ``_build.entry(symbol, dtype)`` (``spfft_fft_stage``,
  ``spfft_gather``, ...) names a function of a built ``csrc/*.cu``
  library, never a series. That is the port's one departure from the
  JAX engine (docs_torch/static_analysis.md).

Checks:

1. referenced name not declared -> error (waivable
   ``# counters: waived(reason)``);
2. ``inc`` on a gauge / ``set`` on a counter -> error;
3. a ``_total``-suffixed name declared as a gauge -> error; a counter
   without the ``_total`` suffix -> warning (exposition convention);
4. declared name never referenced AND not rendered by an exporter
   ``add(...)`` literal or f-string family pattern -> error ("declared
   but never recorded/surfaced");
5. duplicate literal keys inside ``METRIC_SPECS`` -> error.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from .core import Finding, ModuleInfo, PackageIndex, dotted

CHECKER = "counter-registry"

NAME_RE = re.compile(r"^spfft_[a-z][a-z0-9_]*$")
RECORD_METHODS = {"inc": "counter", "set": "gauge", "get": None}
SPECS_NAME = "METRIC_SPECS"
#: Calls whose argument at the given position is a C entry name of a
#: kernel library: ``_build.function(source, symbol, argtypes)`` and
#: ``_build.entry(symbol, dtype)``.
C_ENTRY_CALLS = {"_build.function": 1, "_build.entry": 0}


def _is_metric_literal(value: str) -> bool:
    # a trailing underscore marks a prefix/piece (tempfile prefixes,
    # f-string fragments), never a whole series name
    return (NAME_RE.match(value) is not None
            and not value.endswith("_")
            and not value.startswith("spfft_tpu"))


def _docstring_ids(tree) -> Set[int]:
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def _c_entry_ids(tree) -> Set[int]:
    """Nodes of the C entry names passed to :data:`C_ENTRY_CALLS`."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            pos = C_ENTRY_CALLS.get(dotted(node.func))
            if pos is not None and len(node.args) > pos:
                out.add(id(node.args[pos]))
    return out


def _find_specs(index: PackageIndex):
    """The METRIC_SPECS dict literal: (module, ast.Dict) or None."""
    for mod in index.modules.values():
        for stmt in mod.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = [t for t in stmt.targets
                           if isinstance(t, ast.Name)]
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                targets = [stmt.target]
                value = stmt.value
            else:
                continue
            if any(t.id == SPECS_NAME for t in targets) \
                    and isinstance(value, ast.Dict):
                return mod, value
    return None


def _parse_specs(mod: ModuleInfo, node: ast.Dict,
                 findings: List[Finding]) -> Dict[str, Tuple[str, int]]:
    declared: Dict[str, Tuple[str, int]] = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant)
                and isinstance(k.value, str)):
            continue
        name = k.value
        mtype = ""
        if isinstance(v, (ast.Tuple, ast.List)) and v.elts \
                and isinstance(v.elts[0], ast.Constant):
            mtype = v.elts[0].value
        elif isinstance(v, ast.Call):
            for arg in v.args[:1]:
                if isinstance(arg, ast.Constant):
                    mtype = arg.value
            for kw in v.keywords:
                if kw.arg == "mtype" \
                        and isinstance(kw.value, ast.Constant):
                    mtype = kw.value.value
        if name in declared:
            findings.append(Finding(
                CHECKER, "error", mod.relpath, k.lineno,
                f"metric {name!r} declared more than once in "
                f"{SPECS_NAME}"))
            continue
        declared[name] = (str(mtype), k.lineno)
        if mtype not in ("counter", "gauge"):
            findings.append(Finding(
                CHECKER, "error", mod.relpath, k.lineno,
                f"metric {name!r} has unknown type {mtype!r} "
                f"(want 'counter' or 'gauge')"))
        elif name.endswith("_total") and mtype != "counter":
            findings.append(Finding(
                CHECKER, "error", mod.relpath, k.lineno,
                f"metric {name!r} ends in _total but is declared a "
                f"{mtype} (exposition convention: _total == counter)"))
        elif mtype == "counter" and not name.endswith("_total"):
            findings.append(Finding(
                CHECKER, "warning", mod.relpath, k.lineno,
                f"counter {name!r} does not end in _total "
                f"(exposition convention)"))
    return declared


def _exporter_surfaces(index: PackageIndex):
    """Literal names and f-string family patterns passed to a
    ``.add(name, ...)`` exporter call anywhere in the package."""
    literals: Set[str] = set()
    patterns: List[re.Pattern] = []
    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add" and node.args):
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) \
                    and isinstance(first.value, str):
                if _is_metric_literal(first.value):
                    literals.add(first.value)
            elif isinstance(first, ast.JoinedStr):
                parts = []
                for piece in first.values:
                    if isinstance(piece, ast.Constant):
                        parts.append(re.escape(str(piece.value)))
                    else:
                        parts.append(r"[a-z0-9_]+")
                pat = "^" + "".join(parts) + "$"
                if pat.startswith("^spfft_"):
                    patterns.append(re.compile(pat))
    return literals, patterns


def check(index: PackageIndex) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    specs = _find_specs(index)
    if specs is None:
        findings.append(Finding(
            CHECKER, "error", "obs/counters.py", 1,
            f"no {SPECS_NAME} declaration found — every spfft_* "
            f"series must be declared once in obs/counters.py"))
        return findings, {}
    specs_mod, specs_node = specs
    declared = _parse_specs(specs_mod, specs_node, findings)

    # -- collect references --------------------------------------------------
    referenced: Dict[str, List[Tuple[str, int]]] = {}
    recorded: Set[str] = set()
    for mod in index.modules.values():
        if mod is specs_mod:
            continue
        doc_ids = _docstring_ids(mod.tree) | _c_entry_ids(mod.tree)
        # f-string constituents are fragments, not names
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.JoinedStr):
                for piece in node.values:
                    doc_ids.add(id(piece))
        call_arg_ids: Set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in RECORD_METHODS \
                    and node.args:
                first = node.args[0]
                call_arg_ids.add(id(first))
                if isinstance(first, ast.Constant) \
                        and isinstance(first.value, str) \
                        and _is_metric_literal(first.value):
                    name = first.value
                    referenced.setdefault(name, []).append(
                        (mod.relpath, node.lineno))
                    want = RECORD_METHODS[node.func.attr]
                    recorded.add(name)
                    info = declared.get(name)
                    if info is not None and want is not None \
                            and info[0] in ("counter", "gauge") \
                            and info[0] != want:
                        reason = mod.waiver_for(node, "counters")
                        findings.append(Finding(
                            CHECKER, "error", mod.relpath, node.lineno,
                            f".{node.func.attr}() on {name!r} but it "
                            f"is declared a {info[0]}",
                            waived=reason is not None,
                            reason=reason or ""))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and id(node) not in doc_ids \
                    and id(node) not in call_arg_ids \
                    and _is_metric_literal(node.value):
                referenced.setdefault(node.value, []).append(
                    (mod.relpath, node.lineno))
                recorded.add(node.value)

    # -- referenced but undeclared -------------------------------------------
    for name, sites in sorted(referenced.items()):
        if name in declared:
            continue
        for relpath, lineno in sites:
            mod = index.modules[relpath]
            node_stub = ast.Constant(value=name)
            node_stub.lineno = lineno
            node_stub.end_lineno = lineno
            reason = mod.waiver_for(node_stub, "counters")
            findings.append(Finding(
                CHECKER, "error", relpath, lineno,
                f"series {name!r} recorded here but not declared in "
                f"obs/counters.py {SPECS_NAME}",
                waived=reason is not None, reason=reason or ""))

    # -- declared but never recorded/surfaced --------------------------------
    literals, patterns = _exporter_surfaces(index)
    for name, (mtype, lineno) in sorted(declared.items()):
        if name in recorded or name in literals:
            continue
        if any(p.match(name) for p in patterns):
            continue
        stub = ast.Constant(value=name)
        stub.lineno = lineno
        stub.end_lineno = lineno
        reason = specs_mod.waiver_for(stub, "counters")
        findings.append(Finding(
            CHECKER, "error", specs_mod.relpath, lineno,
            f"metric {name!r} declared in {SPECS_NAME} but never "
            f"recorded or rendered by an exporter",
            waived=reason is not None, reason=reason or ""))

    extras = {"declared_metrics": len(declared),
              "referenced_metrics": len(referenced)}
    return findings, extras
