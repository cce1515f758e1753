"""The port's lint engine (``spfft_tpu_torch.analysis``) against the JAX
package's (``spfft_tpu.analysis``) on the same inputs.

Every source fixture of ``tests/test_analysis.py`` — each module-level
string that parses as Python, each inline one inside a test, and each
``index_sources({...})`` package the file builds from them — is read
from that file with :mod:`ast` (the file is never imported) and run
through both engines' ``index_sources`` and every checker: the findings
(checker, file, line, severity, message, waiver and reason) and the
extras must be identical. The one departure (counter-registry does not
read the C entry names of the port's kernel libraries as series) is
pinned on a fixture that shows both engines' output. Then both CLIs
run in process on a small package under ``tmp_path`` (exit codes 0 / 1
/ 2, ``--list``, ``--baseline-only``, ``--json``, ``-q``), and the
port's once as ``python -m spfft_tpu_torch.analysis``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from spfft_tpu import analysis as janalysis
from spfft_tpu.analysis import __main__ as jmain
from spfft_tpu.analysis import core as jcore
from spfft_tpu_torch import analysis as tanalysis
from spfft_tpu_torch.analysis import __main__ as tmain
from spfft_tpu_torch.analysis import core as tcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_FILE = os.path.join(REPO, "tests", "test_analysis.py")

#: every relpath ``tests/test_analysis.py`` indexes a fixture under
RELPATHS = ("box.py", "m.py", "ab.py", "t.py", "obs/counters.py",
            "obs/rec.py", "obs/exporters.py", "errors.py", "user.py",
            "config.py", "controller.py", "pkg/__init__.py", "faults.py",
            "store.py", "ops.py", "obs/recorder.py", "serve/x.py",
            "cluster.py")

#: the error-taxonomy doc of ``test_error_taxonomy_docs_requirement``
ERRORS_DOC = "| `BaseErr` | base |\n| `BoomError` | boom |\n"


def _is_python(text: str) -> bool:
    try:
        ast.parse(text)
    except SyntaxError:
        return False
    return True


def _harvest():
    """(module-level sources, inline sources, docs, packages) of
    ``tests/test_analysis.py``, evaluated from its AST alone: a fixture
    is a string literal or an expression over earlier fixtures
    (``LOCK_VIOLATION.replace(...)``)."""
    tree = ast.parse(open(FIXTURE_FILE, encoding="utf-8").read())
    module, docs = {}, {}
    for stmt in tree.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            continue
        try:
            value = eval(compile(ast.Expression(stmt.value), "<fixture>",
                                 "eval"), {"__builtins__": {}},
                         dict(module, **docs))
        except Exception:  # noqa: BLE001 - not a fixture (os.path...)
            continue
        if isinstance(value, str):
            (module if _is_python(value) else docs)[
                stmt.targets[0].id] = value
    inline, packages = {}, []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str) \
                    and "\n" in node.value.value \
                    and _is_python(node.value.value):
                inline[f"{fn.name}:{node.lineno}"] = node.value.value
            if isinstance(node, ast.Call) \
                    and getattr(node.func, "id", None) == "index_sources" \
                    and node.args and isinstance(node.args[0], ast.Dict):
                pkg = {}
                for k, v in zip(node.args[0].keys, node.args[0].values):
                    if isinstance(v, ast.Name) and v.id in module:
                        pkg[k.value] = module[v.id]
                    elif isinstance(v, ast.Constant):
                        pkg[k.value] = v.value
                if len(pkg) == len(node.args[0].keys) and pkg not in packages:
                    packages.append(pkg)
    return module, inline, docs, packages


MODULE_FIXTURES, INLINE_FIXTURES, DOC_FIXTURES, PACKAGES = _harvest()


def _rows(findings):
    return [(f.checker, f.path, f.line, f.severity, f.message, f.waived,
             f.reason) for f in findings]


def _every_checker(pkg, core, sources, errors_doc):
    """{run name: (finding rows, extras)} of every checker of the
    engine ``pkg`` over ``core.index_sources(sources)``, the doc-reading
    checkers with and without their docs."""
    index = core.index_sources(sources)
    runs = {
        "locks": lambda: pkg.locks.check(index),
        "spans": lambda: pkg.spans.check(index),
        "counters": lambda: pkg.counters_check.check(index),
        "errors": lambda: pkg.errors_check.check(index),
        "errors+docs": lambda: pkg.errors_check.check(
            index, docs_paths=[errors_doc]),
        "knobs": lambda: pkg.knobs.check(index),
        "faults": lambda: pkg.faults_check.check(index),
        "events": lambda: pkg.events_check.check(index),
        "trace": lambda: pkg.trace_check.check(index),
        "baseline": lambda: pkg.baseline.check(index),
    }
    for name, text in DOC_FIXTURES.items():
        runs[f"knobs+{name}"] = (lambda t: lambda: pkg.knobs.check(
            index, doc_text=t))(text)
    out = {}
    for name, run in runs.items():
        findings, extras = run()
        out[name] = (_rows(findings), extras)
    return out


def _assert_same(sources, tmp_path):
    doc = tmp_path / "taxonomy.md"
    doc.write_text(ERRORS_DOC)
    jax_out = _every_checker(janalysis, jcore, sources, str(doc))
    port_out = _every_checker(tanalysis, tcore, sources, str(doc))
    assert port_out == jax_out
    return jax_out


def test_the_fixtures_are_harvested():
    """The harvest finds the file's fixtures: every checker's clean and
    seeded sources, the knob doc, and the multi-module packages."""
    for name in ("LOCK_VIOLATION", "LOCK_CLEAN", "HOLDS_VIOLATION",
                 "MODULE_LOCK", "ORDER_CYCLE", "ORDER_CLEAN", "SPAN_LEAK",
                 "SPAN_CLOSED_BY", "COUNTERS_DECL", "COUNTERS_OK",
                 "ERRORS_OK", "ERRORS_USER", "KNOBS_OK", "CONTROLLER_OK",
                 "FAULT_SITES_DECL", "FAULT_SITES_OK", "EVENTS_DECL",
                 "EVENTS_OK", "TRACE_CLEAN", "TRACE_CONTEXTLESS_SPAN"):
        assert name in MODULE_FIXTURES, name
    assert "KNOBS_DOC" in DOC_FIXTURES
    assert len(MODULE_FIXTURES) >= 24
    assert len(INLINE_FIXTURES) >= 5
    assert {"obs/counters.py", "obs/rec.py"} in [set(p) for p in PACKAGES]
    assert len(PACKAGES) >= 10


@pytest.mark.parametrize("name", sorted(MODULE_FIXTURES))
def test_module_fixture_findings_equal_jax(name, tmp_path):
    """One module-level fixture, indexed alone under every relpath the
    JAX tests use, through every checker of both engines."""
    for rel in RELPATHS:
        _assert_same({rel: MODULE_FIXTURES[name]}, tmp_path)


@pytest.mark.parametrize("name", sorted(INLINE_FIXTURES))
def test_inline_fixture_findings_equal_jax(name, tmp_path):
    for rel in RELPATHS:
        _assert_same({rel: INLINE_FIXTURES[name]}, tmp_path)


@pytest.mark.parametrize("index", range(len(PACKAGES)),
                         ids=[",".join(sorted(p)) for p in PACKAGES])
def test_fixture_package_findings_equal_jax(index, tmp_path):
    """Each ``index_sources({...})`` package of the JAX tests."""
    _assert_same(PACKAGES[index], tmp_path)


def test_all_fixtures_in_one_package_equal_jax(tmp_path):
    """Every module fixture at once, each under its own path, beside the
    registries at the paths the checkers look for: cross-module
    resolution (imports, by-name calls, the lock graph) over them all."""
    sources = {f"fx/{name.lower()}.py": src
               for name, src in MODULE_FIXTURES.items()}
    sources.update({"obs/counters.py": MODULE_FIXTURES["COUNTERS_DECL"],
                    "errors.py": MODULE_FIXTURES["ERRORS_OK"],
                    "faults.py": MODULE_FIXTURES["FAULT_SITES_DECL"],
                    "obs/recorder.py": MODULE_FIXTURES["EVENTS_DECL"]})
    out = _assert_same(sources, tmp_path)
    assert out["locks"][0] and out["trace"][0] and out["baseline"][0]


# -- the departure: C entry names are not series ------------------------------

C_ENTRIES = '''
import torch
from . import _build


def run(x, dtype, c):
    fn = _build.function("fft.cu", "spfft_fft_stage", ())
    gn = _build.function("gather.cu", _build.entry("spfft_gather", dtype),
                         ())
    c.inc("spfft_demo_hitz_total", 1)
    name = "spfft_demo_ghost"
    return fn, gn, name, torch.float32
'''


def test_c_entry_names_are_not_series():
    """The JAX engine reads the symbol of ``_build.function`` and of
    ``_build.entry`` as undeclared series; the port's does not. Both
    still report the real undeclared series of the same module, and
    the other checkers agree."""
    sources = {"obs/counters.py": MODULE_FIXTURES["COUNTERS_DECL"],
               "obs/rec.py": MODULE_FIXTURES["COUNTERS_OK"],
               "ops/kern.py": C_ENTRIES}
    jf, _ = janalysis.counters_check.check(jcore.index_sources(sources))
    tf, _ = tanalysis.counters_check.check(tcore.index_sources(sources))
    undeclared = "recorded here but not declared"
    jax_names = sorted(f.message.split("'")[1] for f in jf
                       if undeclared in f.message)
    port_names = sorted(f.message.split("'")[1] for f in tf
                        if undeclared in f.message)
    assert jax_names == ["spfft_demo_ghost", "spfft_demo_hitz_total",
                         "spfft_fft_stage", "spfft_gather"]
    assert port_names == ["spfft_demo_ghost", "spfft_demo_hitz_total"]
    assert [r for r in _rows(jf)
            if "spfft_fft_stage" not in r[4]
            and "spfft_gather" not in r[4]] == _rows(tf)
    assert {r[2] for r in _rows(jf)} - {r[2] for r in _rows(tf)} == {7, 8}


def test_c_entry_departure_needs_the_build_module():
    """Only ``_build.function`` / ``_build.entry`` name C entries: the
    same literals passed to another ``function`` / ``entry`` stay series
    for both engines."""
    src = C_ENTRIES.replace("_build.function", "registry.function") \
        .replace("_build.entry", "registry.entry")
    sources = {"obs/counters.py": MODULE_FIXTURES["COUNTERS_DECL"],
               "obs/rec.py": MODULE_FIXTURES["COUNTERS_OK"],
               "ops/kern.py": src}
    jf, _ = janalysis.counters_check.check(jcore.index_sources(sources))
    tf, _ = tanalysis.counters_check.check(tcore.index_sources(sources))
    assert _rows(tf) == _rows(jf)
    assert any("spfft_gather" in r[4] for r in _rows(tf))


# -- the CLI, in process, against the JAX CLI ---------------------------------

CLEAN_PACKAGE = {
    "obs/counters.py": MODULE_FIXTURES["COUNTERS_DECL"],
    "obs/rec.py": ('def record(c):\n'
                   '    c.inc("spfft_demo_hits_total", 1)\n'
                   '    c.set("spfft_demo_depth", 3)\n'),
    "errors.py": MODULE_FIXTURES["ERRORS_OK"],
    "user.py": MODULE_FIXTURES["ERRORS_USER"],
    "control/config.py": MODULE_FIXTURES["KNOBS_OK"],
    "faults.py": MODULE_FIXTURES["FAULT_SITES_DECL"],
    "store.py": MODULE_FIXTURES["FAULT_SITES_OK"],
    "obs/recorder.py": MODULE_FIXTURES["EVENTS_DECL"],
    "serve/x.py": MODULE_FIXTURES["EVENTS_OK"],
    "cluster.py": MODULE_FIXTURES["TRACE_CLEAN"],
}


def _package(tmp_path, sources, name="pkg"):
    root = tmp_path / name
    for rel, src in sources.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return str(root)


def _both(argv, capsys):
    """(exit code, stdout) of the JAX CLI and of the port's on ``argv``;
    argparse's own exits are caught as their code."""
    out = []
    for main in (jmain.main, tmain.main):
        try:
            rc = main(list(argv))
        except SystemExit as exc:
            rc = exc.code
        out.append((rc, capsys.readouterr().out))
    return out


def test_cli_clean_package_exits_0_like_jax(tmp_path, capsys):
    root = _package(tmp_path, CLEAN_PACKAGE)
    (jax_rc, jax_out), (rc, out) = _both(["--root", root], capsys)
    assert rc == jax_rc == 0
    assert out == jax_out
    assert "0 error(s), 0 warning(s), 0 waiver(s)" in out
    (jax_rc, jax_out), (rc, out) = _both(["--root", root, "-q"], capsys)
    assert (rc, out) == (jax_rc, jax_out) == (0, "")


def test_cli_unwaived_error_exits_1_like_jax(tmp_path, capsys):
    sources = dict(CLEAN_PACKAGE)
    sources["obs/rec.py"] = sources["obs/rec.py"].replace(
        "spfft_demo_hits_total", "spfft_demo_hitz_total")
    root = _package(tmp_path, sources)
    for argv in (["--root", root], ["--root", root, "-q"]):
        (jax_rc, jax_out), (rc, out) = _both(argv, capsys)
        assert rc == jax_rc == 1
        assert out == jax_out
        assert "spfft_demo_hitz_total" in out


def test_cli_usage_errors_exit_2_like_jax(tmp_path, capsys):
    root = _package(tmp_path, dict(CLEAN_PACKAGE, **{"bad.py": "def (:\n"}))
    (jax_rc, _), (rc, _) = _both(["--root", root], capsys)
    assert rc == jax_rc == 2
    (jax_rc, _), (rc, _) = _both(["--checker", "no-such-checker"], capsys)
    assert rc == jax_rc == 2
    (jax_rc, _), (rc, _) = _both(["--no-such-flag"], capsys)
    assert rc == jax_rc == 2


def test_cli_list_like_jax(capsys):
    (jax_rc, jax_out), (rc, out) = _both(["--list"], capsys)
    assert (rc, out) == (jax_rc, jax_out)
    assert out.split() == list(tanalysis.CHECKERS)


def test_cli_baseline_only_like_jax(tmp_path, capsys):
    sources = dict(CLEAN_PACKAGE, **{"lint.py": "import os\n"})
    root = _package(tmp_path, sources)
    (jax_rc, jax_out), (rc, out) = _both(["--root", root, "--baseline-only"],
                                         capsys)
    assert rc == jax_rc == 1
    assert out == jax_out
    assert "lint.py:1: error: [baseline-lint] unused import" in out
    assert out.rstrip().endswith("waiver(s) [baseline-lint]")


def test_cli_checker_selection_like_jax(tmp_path, capsys):
    root = _package(tmp_path, CLEAN_PACKAGE)
    argv = ["--root", root, "--checker", "lock-discipline", "--checker",
            "fault-sites"]
    (jax_rc, jax_out), (rc, out) = _both(argv, capsys)
    assert (rc, out) == (jax_rc, jax_out)
    assert out.rstrip().endswith("[lock-discipline, fault-sites]")


def test_cli_json_report_like_jax(tmp_path, capsys):
    sources = dict(CLEAN_PACKAGE)
    sources["store.py"] += (
        '\n\ndef probe():\n    _faults.check_site("store.probe")'
        '  # faults: waived(staging)\n')
    root = _package(tmp_path, sources)
    reports = []
    for i, main in enumerate((jmain.main, tmain.main)):
        path = tmp_path / f"report{i}.json"
        assert main(["--root", root, "--json", str(path), "-q"]) == 0
        reports.append(json.loads(path.read_text()))
    capsys.readouterr()
    assert reports[1] == reports[0]
    assert reports[1]["ok"] is True
    assert reports[1]["summary"] == {"errors": 0, "warnings": 0,
                                     "waivers": 1}
    assert reports[1]["waivers"][0]["reason"] == "staging"
    assert set(reports[1]) == {"ok", "checkers", "summary", "findings",
                               "waivers", "extras"}


def test_cli_docs_root_reads_readme_and_docs_like_jax(tmp_path, capsys):
    """With ``--docs-root`` both engines read ``README.md`` and
    ``docs/*.md`` (an undocumented class is an error); without it the
    port reads ``docs_torch/`` beside the package, never ``docs/``."""
    root = _package(tmp_path, CLEAN_PACKAGE)
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "errors.md").write_text("| `BaseErr` | base |\n")
    (jax_rc, jax_out), (rc, out) = _both(
        ["--root", root, "--docs-root", str(tmp_path),
         "--checker", "error-taxonomy"], capsys)
    assert rc == jax_rc == 1
    assert out == jax_out and "BoomError has no row" in out
    assert tmain.main(["--root", root, "--checker", "error-taxonomy"]) == 0
    port_docs = tmp_path / tanalysis.PORT_DOCS
    port_docs.mkdir()
    (port_docs / "errors.md").write_text("| `BoomError` | boom |\n")
    assert tmain.main(["--root", root, "--checker", "error-taxonomy"]) == 1
    assert "BaseErr has no row" in capsys.readouterr().out
    (port_docs / "errors.md").write_text(ERRORS_DOC)
    assert tmain.main(["--root", root, "--checker", "error-taxonomy",
                       "-q"]) == 0


def test_cli_module_smoke(tmp_path):
    """``python -m spfft_tpu_torch.analysis`` as a process: exit 1 and
    the finding on a dirty package, exit 0 and a JSON report on a clean
    one."""
    sources = dict(CLEAN_PACKAGE, **{"lint.py": "import os\n"})
    dirty = _package(tmp_path, sources, "dirty")
    clean = _package(tmp_path, CLEAN_PACKAGE, "clean")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "spfft_tpu_torch.analysis", "--root", dirty],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "lint.py:1: error: [baseline-lint] unused import" in proc.stdout
    report = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "spfft_tpu_torch.analysis", "--root", clean,
         "--json", str(report), "-q"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
    assert json.loads(report.read_text())["checkers"] == list(
        tanalysis.CHECKERS)
