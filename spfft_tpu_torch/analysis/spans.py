"""Span-closure checker: every obs span opened must have a closure
story on all paths.

The contract — zero unclosed spans on every failure path — is
runtime-tested by the fault suite; this checker makes its *shape*
static. A span-open site is any ``<recv>.begin(...)`` call (the
package's only span-opening spelling outside the ``with
tracer.span(...)`` context manager, which closes itself). Each open
site must satisfy one of:

1. **Handler closure** — the enclosing function contains a close call
   (``finish`` / ``close`` / ``end`` / ``end_all``) on the same
   receiver chain inside an ``except`` handler or ``finally`` block
   (the begin-then-try idiom: ``Tracer.span`` itself, the executor's
   bucket paths), meaning an exception cannot escape with the span
   open.
2. **Sweep closure** — the function contains a sweeping close
   (``close`` / ``end_all``) on the same receiver after the open (the
   resolve-then-settle idiom).
3. **Declared cross-function closure** — ``# span: closed-by(<target>)``
   on the open line; the checker verifies the target function exists in
   the index and itself contains a close call. This is how the
   executor's submit-thread-opens / dispatcher-closes handoff is
   declared (``serve.queue_wait``).
4. **Waiver** — ``# span: waived(reason)``, listed in the report.

Close calls on a DIFFERENT receiver chain never satisfy a site: closing
``other.trace`` cannot settle ``req.trace``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .core import Finding, PackageIndex, dotted

CHECKER = "span-closure"

OPEN_METHODS = {"begin"}
CLOSE_METHODS = {"finish", "close", "end", "end_all"}
SWEEP_METHODS = {"close", "end_all"}


def _recv_chain(call: ast.Call) -> Optional[str]:
    """Receiver chain of a method call: ``req.trace.finish(...)`` ->
    ``req.trace``; plain-name calls return None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    return dotted(call.func.value)


def _method(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


class _SpanVisitor(ast.NodeVisitor):
    """Collects open sites and close sites (with handler/finally
    context) in one function body."""

    def __init__(self):
        self.opens: List[Tuple[ast.Call, str]] = []
        #: (line, receiver chain, method, in_handler)
        self.closes: List[Tuple[int, str, str, bool]] = []
        self._handler_depth = 0

    def visit_Try(self, node: ast.Try):
        for stmt in node.body:
            self.visit(stmt)
        for stmt in node.orelse:
            self.visit(stmt)
        self._handler_depth += 1
        for handler in node.handlers:
            for stmt in handler.body:
                self.visit(stmt)
        for stmt in node.finalbody:
            self.visit(stmt)
        self._handler_depth -= 1

    def visit_Call(self, node: ast.Call):
        meth = _method(node)
        recv = _recv_chain(node)
        if meth in OPEN_METHODS and recv is not None:
            self.opens.append((node, recv))
        elif meth in CLOSE_METHODS and recv is not None:
            self.closes.append((node.lineno, recv, meth,
                                self._handler_depth > 0))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        return  # nested defs analysed separately

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef


def _iter_functions(index: PackageIndex):
    for mod in index.modules.values():
        for fi in mod.functions.values():
            yield mod, fi
        for ci in mod.classes.values():
            for fi in ci.methods.values():
                yield mod, fi


def _target_exists_and_closes(index: PackageIndex,
                              target: str) -> bool:
    """closed-by(<target>): the named function exists and contains a
    close call. Accepts ``Class.method``, ``function`` or a full
    ``module::Class.method`` spelling."""
    for mod, fi in _iter_functions(index):
        qual = fi.qualname
        short = qual.split("::", 1)[-1]
        if target not in (qual, short, fi.name):
            continue
        v = _SpanVisitor()
        for stmt in fi.node.body:
            v.visit(stmt)
        if v.closes:
            return True
    return False


def check(index: PackageIndex) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    open_count = 0
    for mod, fi in _iter_functions(index):
        v = _SpanVisitor()
        for stmt in fi.node.body:
            v.visit(stmt)
        if not v.opens:
            continue
        for node, recv in v.opens:
            open_count += 1
            # Tracer.begin's own definition is the primitive, not a
            # call site; a method NAMED begin whose body this is never
            # appears here because we only look at calls.
            handler_close = any(r == recv and in_handler
                                for (_, r, _, in_handler) in v.closes)
            sweep_close = any(r == recv and m in SWEEP_METHODS
                              and line >= node.lineno
                              for (line, r, m, _) in v.closes)
            if handler_close or sweep_close:
                continue
            target = mod.closed_by_for(node)
            if target is not None:
                if _target_exists_and_closes(index, target):
                    continue
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, node.lineno,
                    f"span opened on {recv!r} declares closed-by"
                    f"({target}) but no such function with a close "
                    f"call exists in the package"))
                continue
            reason = mod.waiver_for(node, "span")
            findings.append(Finding(
                CHECKER, "error", mod.relpath, node.lineno,
                f"span opened on {recv!r} in {fi.qualname} has no "
                f"closure on all paths: no handler/finally close, no "
                f"sweeping close after it, and no "
                f"`# span: closed-by(...)` declaration",
                waived=reason is not None, reason=reason or ""))
    return findings, {"span_open_sites": open_count}
