"""Knob-registry checker.

``control/config.py``'s ``KNOB_SPECS`` (+ ``PATH_SETTINGS``) is THE
declared home of every serving knob; this checker keeps the
declaration, the env-var spellings and the operator docs in sync:

1. **Spec sanity** — every ``KnobSpec(name, default, lo, hi, kind,
   ...)``: ``lo <= default <= hi``, ``kind`` is ``int`` or ``float``,
   an int knob's bounds/default are integral.
2. **Docs row** — every knob and path setting has a row in the "Knob
   reference" table of the knob doc (the port's
   ``docs_torch/control_plane.md``, or ``docs/control_plane.md`` under
   a given docs root) whose default and
   ``[lo, hi]`` bounds match the code; a table row naming an unknown
   knob (stale docs after a rename) is an error.
3. **Env spelling** — the table's env column must name an
   ``SPFFT_TPU_*`` literal that actually appears in the package
   source, and any source env literal whose suffix is a near-miss of a
   knob's canonical ``SPFFT_TPU_<KNOB>`` spelling (edit distance 1-2,
   not exact) is flagged — the typo'd-env-that-silently-does-nothing
   failure mode.
4. **Controller coverage** — the controller's ``MANAGED_KNOBS``
   declaration and its feedback rules must agree: a managed knob no
   ``_retune(...)`` call ever moves (the idle decay walks it but
   nothing drives it away from default — dead management), or a rule
   moving a knob missing from ``MANAGED_KNOBS`` (it never decays back
   on idle), is a finding; so is a managed name that is not a declared
   knob at all.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ModuleInfo, PackageIndex

CHECKER = "knob-registry"

ENV_RE = re.compile(r"SPFFT_TPU_[A-Z0-9_]+")
ROW_RE = re.compile(r"^\|\s*`([A-Za-z_][A-Za-z0-9_]*)`\s*\|(.*)$")


def _fold(node) -> Optional[float]:
    """Constant-fold the numeric expressions KNOB_SPECS uses
    (``2 * 1024 ** 3`` etc.)."""
    if isinstance(node, ast.Constant) \
            and isinstance(node.value, (int, float)):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _fold(node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        left, right = _fold(node.left), _fold(node.right)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.Pow):
            return left ** right
        if isinstance(node.op, ast.Div):
            return left / right
    return None


class KnobDecl:
    __slots__ = ("name", "default", "lo", "hi", "kind", "lineno")

    def __init__(self, name, default, lo, hi, kind, lineno):
        self.name = name
        self.default = default
        self.lo = lo
        self.hi = hi
        self.kind = kind
        self.lineno = lineno


def _find_config(index: PackageIndex):
    for mod in index.modules.values():
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                if any(isinstance(t, ast.Name)
                       and t.id == "KNOB_SPECS" for t in targets):
                    return mod, stmt.value
    return None


def _parse_knobs(mod: ModuleInfo, value,
                 findings: List[Finding]) -> List[KnobDecl]:
    """KnobSpec(...) calls inside the KNOB_SPECS dict-comprehension
    (or a plain dict of calls)."""
    decls: List[KnobDecl] = []
    for node in ast.walk(value):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "KnobSpec"):
            continue
        args = node.args
        if len(args) < 5 or not (isinstance(args[0], ast.Constant)
                                 and isinstance(args[0].value, str)):
            findings.append(Finding(
                CHECKER, "error", mod.relpath, node.lineno,
                "KnobSpec entry not statically parseable (want "
                "positional name, default, lo, hi, kind)"))
            continue
        name = args[0].value
        default, lo, hi = (_fold(args[1]), _fold(args[2]),
                           _fold(args[3]))
        kind = args[4].id if isinstance(args[4], ast.Name) else None
        decls.append(KnobDecl(name, default, lo, hi, kind,
                              node.lineno))
    return decls


def _path_settings(mod: ModuleInfo) -> List[Tuple[str, int]]:
    for stmt in mod.tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if any(isinstance(t, ast.Name)
                   and t.id == "PATH_SETTINGS" for t in targets) \
                    and isinstance(stmt.value, ast.Dict):
                return [(k.value, k.lineno) for k in stmt.value.keys
                        if isinstance(k, ast.Constant)]
    return []


def _env_literals(index: PackageIndex) -> Set[str]:
    out: Set[str] = set()
    for mod in index.modules.values():
        for m in ENV_RE.finditer(mod.source):
            out.add(m.group(0))
    return out


def _edit_distance(a: str, b: str, cap: int = 3) -> int:
    if abs(len(a) - len(b)) >= cap:
        return cap
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        if min(cur) >= cap:
            return cap
        prev = cur
    return min(prev[-1], cap)


def _doc_rows(doc_text: str) -> Dict[str, Tuple[str, int]]:
    """{name: (rest-of-row, line number)} for ``| `name` | ...`` table
    rows in the knob reference doc."""
    rows: Dict[str, Tuple[str, int]] = {}
    for lineno, line in enumerate(doc_text.splitlines(), 1):
        m = ROW_RE.match(line.strip())
        if m and m.group(1) not in rows:
            rows[m.group(1)] = (m.group(2), lineno)
    return rows


def _find_managed(index: PackageIndex):
    """The controller's ``MANAGED_KNOBS`` declaration: the module, the
    declared (name, lineno) entries, and the knob-name literals passed
    to ``self._retune(out, "<knob>", ...)`` anywhere in that module.
    Returns None when no module declares MANAGED_KNOBS (fixture indexes
    without a controller stay out of section 4)."""
    for mod in index.modules.values():
        for stmt in mod.tree.body:
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if not any(isinstance(t, ast.Name)
                       and t.id == "MANAGED_KNOBS" for t in targets):
                continue
            entries: List[Tuple[str, int]] = []
            if isinstance(stmt.value, (ast.Tuple, ast.List)):
                for el in stmt.value.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        entries.append((el.value, el.lineno))
            retuned: Dict[str, int] = {}
            for node in ast.walk(mod.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "_retune"
                        and len(node.args) >= 2
                        and isinstance(node.args[1], ast.Constant)
                        and isinstance(node.args[1].value, str)):
                    retuned.setdefault(node.args[1].value, node.lineno)
            return mod, entries, retuned
    return None


def _num(cell: str) -> Optional[float]:
    cell = cell.strip().strip("`")
    try:
        return float(cell)
    except ValueError:
        return None


def check(index: PackageIndex,
          doc_path: Optional[str] = None,
          doc_text: Optional[str] = None
          ) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    found = _find_config(index)
    if found is None:
        findings.append(Finding(
            CHECKER, "error", "control/config.py", 1,
            "no KNOB_SPECS declaration found"))
        return findings, {}
    mod, value = found
    decls = _parse_knobs(mod, value, findings)
    paths = _path_settings(mod)

    # 1 — spec sanity
    for d in decls:
        if None in (d.default, d.lo, d.hi):
            findings.append(Finding(
                CHECKER, "error", mod.relpath, d.lineno,
                f"knob {d.name!r}: default/lo/hi not constant-foldable"))
            continue
        if not (d.lo <= d.default <= d.hi):
            findings.append(Finding(
                CHECKER, "error", mod.relpath, d.lineno,
                f"knob {d.name!r}: default {d.default} outside "
                f"declared bounds [{d.lo}, {d.hi}]"))
        if d.kind not in ("int", "float"):
            findings.append(Finding(
                CHECKER, "error", mod.relpath, d.lineno,
                f"knob {d.name!r}: kind must be int or float, got "
                f"{d.kind!r}"))
        elif d.kind == "int":
            for label, v in (("default", d.default), ("lo", d.lo),
                             ("hi", d.hi)):
                if v is not None and float(v) != int(v):
                    findings.append(Finding(
                        CHECKER, "error", mod.relpath, d.lineno,
                        f"int knob {d.name!r}: {label} {v} is not "
                        f"integral"))

    # 3a — env near-miss scan (code side)
    envs = _env_literals(index)
    known = {f"SPFFT_TPU_{d.name.upper()}" for d in decls}
    known |= {f"SPFFT_TPU_{name.upper()}" for name, _ in paths}
    for env in sorted(envs):
        if env in known:
            continue
        for want in sorted(known):
            dist = _edit_distance(env, want)
            if 0 < dist <= 2:
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, 1,
                    f"env var {env!r} found in source is a near-miss "
                    f"of the canonical knob env {want!r} — typo'd "
                    f"knob envs silently do nothing"))
                break

    # 2/3b — docs table cross-check
    if doc_text is None and doc_path is not None \
            and os.path.exists(doc_path):
        with open(doc_path, "r", encoding="utf-8") as f:
            doc_text = f.read()
    if doc_text is not None:
        rows = _doc_rows(doc_text)
        doc_rel = doc_path or "docs/control_plane.md"
        declared_names = {d.name for d in decls} \
            | {name for name, _ in paths}
        for d in decls:
            row = rows.get(d.name)
            if row is None:
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, d.lineno,
                    f"knob {d.name!r} has no row in the knob "
                    f"reference table of {doc_rel}"))
                continue
            rest, rowline = row
            cells = [c.strip() for c in rest.strip("|").split("|")]
            # cells: default | bounds | env | signal...
            if len(cells) >= 2:
                doc_default = _num(cells[0])
                if doc_default is not None and d.default is not None \
                        and doc_default != float(d.default):
                    findings.append(Finding(
                        CHECKER, "error", doc_rel, rowline,
                        f"knob {d.name!r}: documented default "
                        f"{cells[0]} != declared {d.default}"))
                bm = re.match(r"^\[([^,\]]+),\s*([^\]]+)\]$",
                              cells[1])
                if bm and d.lo is not None and d.hi is not None:
                    doc_lo, doc_hi = _num(bm.group(1)), \
                        _num(bm.group(2))
                    if (doc_lo, doc_hi) != (float(d.lo), float(d.hi)):
                        findings.append(Finding(
                            CHECKER, "error", doc_rel, rowline,
                            f"knob {d.name!r}: documented bounds "
                            f"{cells[1]} != declared [{d.lo}, "
                            f"{d.hi}]"))
            if len(cells) >= 3:
                env_cell = cells[2].strip("`")
                if env_cell and env_cell not in ("—", "-", ""):
                    if env_cell not in envs:
                        findings.append(Finding(
                            CHECKER, "error", doc_rel, rowline,
                            f"knob {d.name!r}: documented env "
                            f"{env_cell!r} does not appear in the "
                            f"package source"))
        for name, lineno in paths:
            if name not in rows:
                findings.append(Finding(
                    CHECKER, "error", mod.relpath, lineno,
                    f"path setting {name!r} has no row in the knob "
                    f"reference table of {doc_rel}"))
        for name, (_rest, rowline) in rows.items():
            if name not in declared_names:
                findings.append(Finding(
                    CHECKER, "error", doc_rel, rowline,
                    f"knob reference table row {name!r} matches no "
                    f"declared knob or path setting (stale docs?)"))

    # 4 — controller coverage: MANAGED_KNOBS vs the _retune rules
    managed_count = 0
    managed = _find_managed(index)
    if managed is not None:
        cmod, entries, retuned = managed
        managed_count = len(entries)
        declared = {d.name for d in decls}
        managed_names = {name for name, _ in entries}
        for name, lineno in entries:
            if name not in declared:
                findings.append(Finding(
                    CHECKER, "error", cmod.relpath, lineno,
                    f"MANAGED_KNOBS entry {name!r} is not a declared "
                    f"knob in KNOB_SPECS"))
            elif name not in retuned:
                findings.append(Finding(
                    CHECKER, "error", cmod.relpath, lineno,
                    f"managed knob {name!r} has no controller rule — "
                    f"no _retune(...) call ever moves it, so the idle "
                    f"decay manages a knob nothing drives"))
        for name, lineno in sorted(retuned.items()):
            if name not in managed_names:
                findings.append(Finding(
                    CHECKER, "error", cmod.relpath, lineno,
                    f"controller rule moves knob {name!r} which is "
                    f"not in MANAGED_KNOBS — it will never decay back "
                    f"to default on idle"))

    return findings, {"knobs": len(decls), "path_settings": len(paths),
                      "managed_knobs": managed_count}
