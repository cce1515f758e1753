"""Cross-host trace-context propagation checker.

The pod frontend's federated-telemetry contract (``serve/cluster.py``) is
that one trace id survives the host boundary: the frontend opens the
``cluster.request`` root span, captures its ``obs.TraceContext`` and
every RPC that executes traced work on a host lane must CARRY that
context through — so the lane's spans nest under the frontend's and a
Perfetto view of a pod request reads as one tree, not N orphans. Like
the lock-order graph, that contract spans functions and files, which
is exactly where review discipline leaks; this checker makes it a
machine-checked annotation.

Annotation grammar::

    # trace: boundary(<param>)

on (or directly above) a ``def`` line marks that function as an RPC
boundary whose ``<param>`` is the propagated trace context. Three
rules then hold:

1. **carry** — the boundary body must forward ``<param>`` into at
   least one call (an ``executor.submit(..., trace_ctx=ctx)``, a
   ``begin(parent=ctx)``, a wire encoding ``ctx.to_wire()`` — anything
   that references it as a call input). A boundary that never touches
   its context silently orphans every downstream span.
2. **restore** — every ``.begin(`` span-open inside the boundary must
   reference ``<param>`` among its arguments: a span opened at an
   annotated RPC boundary without the propagated context starts a NEW
   trace id on the far side of the wire, which is precisely the bug
   class this checker exists for.
3. **bind** — every resolvable call of a boundary function (matched by
   callee name across the package) must bind ``<param>``, positionally
   or by keyword (``**kwargs`` forwarding counts). A caller that
   drops the context breaks the chain one hop earlier.

Violations are errors, waivable with ``# trace: waived(<reason>)`` on
the offending line (all waivers are listed in the report). Non-literal
/ dynamic dispatch is out of scope by design — the cluster RPC surface
is deliberately direct (``lane.rpc_submit(...)``) so rule 3 can
resolve its call sites statically.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from .core import Finding, FunctionInfo, ModuleInfo, PackageIndex

CHECKER = "trace-context"

BOUNDARY_RE = re.compile(
    r"#\s*trace\s*:\s*boundary\(([A-Za-z_][A-Za-z0-9_]*)\)")


def _boundary_param(mod: ModuleInfo, fi: FunctionInfo):
    """The ``# trace: boundary(param)`` annotation covering ``fi``'s
    signature (any signature line, or a standalone comment directly
    above the def), or None."""
    node = fi.node
    sig_end = node.body[0].lineno - 1 if node.body else node.lineno
    lines = list(range(node.lineno, sig_end + 1))
    if node.lineno - 1 in mod.standalone_comment_lines:
        lines.insert(0, node.lineno - 1)
    for line in lines:
        m = mod.comment_match(BOUNDARY_RE, line)
        if m:
            return m.group(1)
    return None


def _params(node) -> List[str]:
    args = node.args
    return [a.arg for a in
            list(args.posonlyargs) + list(args.args)]


def _call_references(call: ast.Call, param: str) -> bool:
    """Does ``param`` appear anywhere among the call's inputs?"""
    for sub in list(call.args) + [kw.value for kw in call.keywords]:
        for n in ast.walk(sub):
            if isinstance(n, ast.Name) and n.id == param:
                return True
    return False


def _callee_tail(call: ast.Call) -> str:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return ""


def _waived(mod: ModuleInfo, node, findings: List[Finding],
            message: str) -> None:
    reason = mod.waiver_for(node, "trace")
    findings.append(Finding(
        CHECKER, "error", mod.relpath, node.lineno, message,
        waived=reason is not None, reason=reason or ""))


def check(index: PackageIndex) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []

    # -- collect annotated boundaries ---------------------------------------
    #: bare function name -> [(mod, fi, param)]
    boundaries: Dict[str, List[Tuple[ModuleInfo, FunctionInfo, str]]] \
        = {}
    for mod in index.modules.values():
        if mod.relpath.startswith("analysis/"):
            continue
        funcs = list(mod.functions.values())
        for ci in mod.classes.values():
            funcs.extend(ci.methods.values())
        for fi in funcs:
            param = _boundary_param(mod, fi)
            if param is None:
                continue
            if param not in _params(fi.node) and param not in \
                    [a.arg for a in fi.node.args.kwonlyargs]:
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, fi.node.lineno,
                    f"boundary annotation names {param!r}, which is "
                    f"not a parameter of {fi.qualname}"))
                continue
            boundaries.setdefault(fi.name, []).append((mod, fi, param))

    # -- rules 1+2: inside each boundary ------------------------------------
    for entries in boundaries.values():
        for mod, fi, param in entries:
            forwarded = False
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                if _call_references(node, param):
                    forwarded = True
                if _callee_tail(node) == "begin" \
                        and not _call_references(node, param):
                    _waived(mod, node, findings,
                            f"span opened inside trace boundary "
                            f"{fi.qualname} without its context "
                            f"{param!r} — this starts a new trace id "
                            f"across the host boundary")
            if not forwarded:
                _waived(mod, fi.node, findings,
                        f"trace boundary {fi.qualname} never forwards "
                        f"its context {param!r} into any call — "
                        f"downstream spans are orphaned")

    # -- rule 3: every resolvable call binds the context --------------------
    calls_checked = 0
    for mod in index.modules.values():
        if mod.relpath.startswith("analysis/"):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _callee_tail(node)
            entries = boundaries.get(name)
            if not entries:
                continue
            bmod, bfi, param = entries[0]
            calls_checked += 1
            params = _params(bfi.node)
            if param in params:
                pos = params.index(param)
                if params and params[0] in ("self", "cls") \
                        and isinstance(node.func, ast.Attribute):
                    pos -= 1
                bound_pos = len(node.args) > pos >= 0
            else:
                bound_pos = False  # keyword-only context parameter
            bound_kw = any(kw.arg == param or kw.arg is None
                           for kw in node.keywords)
            if not (bound_pos or bound_kw):
                _waived(mod, node, findings,
                        f"call of trace boundary {bfi.qualname} does "
                        f"not bind its context parameter {param!r} — "
                        f"the trace chain breaks here")

    extras = {"trace_boundaries":
              sum(len(v) for v in boundaries.values()),
              "boundary_calls_checked": calls_checked}
    return findings, extras
