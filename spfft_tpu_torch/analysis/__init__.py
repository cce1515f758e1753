"""spfft_tpu_torch.analysis — the port's project lint engine.

The port's own copy of ``spfft_tpu/analysis/``: an AST-based
static-analysis pass that enforces the contracts the code already
claims (see docs_torch/static_analysis.md for the checker catalogue,
the annotation syntax and the port's departures):

* ``lock-discipline`` / ``lock-order`` — ``#: guarded by _lock``
  fields only touched under their lock; acquisition-order graph with
  deadlock-shape (cycle) detection (:mod:`.locks`);
* ``span-closure`` — every obs span open site has a closure story on
  all paths (:mod:`.spans`);
* ``counter-registry`` — every ``spfft_*`` series declared exactly
  once in ``obs/counters.py`` and surfaced by ``prometheus_text``; the
  C entry names of the kernel libraries are not series
  (:mod:`.counters_check`);
* ``error-taxonomy`` — every exception class carries a code, is
  raised somewhere and is documented (:mod:`.errors_check`);
* ``knob-registry`` — ``KNOB_SPECS`` sanity, env spellings, docs rows
  (:mod:`.knobs`);
* ``fault-sites`` — every fault-injection check names a site declared
  exactly once in ``faults.SITES``, and every declared site is checked
  somewhere (:mod:`.faults_check`);
* ``event-registry`` — every ``record_event`` kind declared exactly
  once in ``obs/recorder.py``'s ``EVENT_SPECS``, every declared kind
  emitted, attrs inside the declared key set (:mod:`.events_check`);
* ``trace-context`` — every ``# trace: boundary(param)``-annotated
  cluster RPC boundary forwards its propagated trace context, opens
  no context-less span, and is never called without the context bound
  (:mod:`.trace_check`);
* ``baseline-lint`` — unused imports + undefined names
  (:mod:`.baseline`).

Run with ``python -m spfft_tpu_torch.analysis``; the package is parsed
ONCE (:func:`core.index_package`) and every checker consumes the shared
index.

Docs. The error-taxonomy and knob-registry checkers read docs. With a
``docs_root`` they read ``<docs_root>/README.md`` and
``<docs_root>/docs/*.md``, and the knob table of
``<docs_root>/docs/control_plane.md``, as the JAX engine does. Without
one they read the port's own docs, :data:`PORT_DOCS` beside the
analysed package: its ``*.md`` files and its ``control_plane.md``
(never ``docs/``, which documents the JAX package).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from . import (baseline, counters_check, errors_check, events_check,
               faults_check, knobs, locks, spans, trace_check)
from .core import (Finding, PackageIndex, Report, index_package,
                   index_sources)

__all__ = ["Finding", "PackageIndex", "Report", "index_package",
           "index_sources", "run_analysis", "CHECKERS", "PORT_DOCS"]

#: Checker names, in the order :func:`run_analysis` runs them.
CHECKERS = ("lock-discipline", "span-closure", "counter-registry",
            "error-taxonomy", "knob-registry", "fault-sites",
            "event-registry", "trace-context", "baseline-lint")

#: The port's docs directory, beside the package it documents.
PORT_DOCS = "docs_torch"


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    return os.path.dirname(package_root())


def docs_paths(root: str, docs_root: Optional[str]
               ) -> Tuple[List[str], str]:
    """The error-taxonomy docs and the knob reference doc for the
    package at ``root``: under ``docs_root`` as the JAX engine reads
    them where one is given, else the port's :data:`PORT_DOCS`."""
    if docs_root is not None:
        return (errors_check.default_docs_paths(docs_root),
                os.path.join(docs_root, "docs", "control_plane.md"))
    port = os.path.join(os.path.dirname(os.path.abspath(root)), PORT_DOCS)
    found = sorted(fn for fn in os.listdir(port) if fn.endswith(".md")) \
        if os.path.isdir(port) else []
    return ([os.path.join(port, fn) for fn in found],
            os.path.join(port, "control_plane.md"))


def run_analysis(root: Optional[str] = None,
                 checkers: Optional[List[str]] = None,
                 docs_root: Optional[str] = None) -> Report:
    """Run the selected ``checkers`` (default: all) over the package at
    ``root`` (default: the installed spfft_tpu_torch package), with the
    docs :func:`docs_paths` picks, and return the combined
    :class:`Report`."""
    root = root or package_root()
    selected = list(checkers) if checkers else list(CHECKERS)
    unknown = set(selected) - set(CHECKERS)
    if unknown:
        raise ValueError(f"unknown checkers: {sorted(unknown)} "
                         f"(available: {list(CHECKERS)})")
    index = index_package(root)
    error_docs, knob_doc = docs_paths(root, docs_root)
    report = Report()
    if "lock-discipline" in selected:
        findings, extras = locks.check(index)
        report.extend("lock-discipline", findings)
        report.extras.update(extras)
    if "span-closure" in selected:
        findings, extras = spans.check(index)
        report.extend("span-closure", findings)
        report.extras.update(extras)
    if "counter-registry" in selected:
        findings, extras = counters_check.check(index)
        report.extend("counter-registry", findings)
        report.extras.update(extras)
    if "error-taxonomy" in selected:
        findings, extras = errors_check.check(
            index, docs_paths=error_docs or None)
        report.extend("error-taxonomy", findings)
        report.extras.update(extras)
    if "knob-registry" in selected:
        findings, extras = knobs.check(
            index, doc_path=knob_doc if os.path.exists(knob_doc) else None)
        report.extend("knob-registry", findings)
        report.extras.update(extras)
    if "fault-sites" in selected:
        findings, extras = faults_check.check(index)
        report.extend("fault-sites", findings)
        report.extras.update(extras)
    if "event-registry" in selected:
        findings, extras = events_check.check(index)
        report.extend("event-registry", findings)
        report.extras.update(extras)
    if "trace-context" in selected:
        findings, extras = trace_check.check(index)
        report.extend("trace-context", findings)
        report.extras.update(extras)
    if "baseline-lint" in selected:
        findings, extras = baseline.check(index)
        report.extend("baseline-lint", findings)
        report.extras.update(extras)
    return report
