"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program under test."""

import ast
import json
import subprocess
import sys

from portbench_support import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "spfft_tpu"}


def test_no_jax_in_the_harness_process():
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1])\n"
        "from portbench import harness, spec, calibrate, run\n"
        "import portbench.reference.dense\n"
        "cell = spec.Cell(spec.load_benchmark(), "
        "'c2c256_f32.bands_b8'); cell.readers()\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "spfft_tpu_torch" in tops and "portbench" in tops
    assert not tops & FORBIDDEN


def test_run_reports_forbidden_modules():
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "portbench"))
    assert "spfft_tpu_torch" not in run.FORBIDDEN
    sys.modules["spfft_tpu.fake"] = object()
    try:
        assert run.forbidden_modules() == ["spfft_tpu"]
    finally:
        del sys.modules["spfft_tpu.fake"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "portbench" / "reference").glob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & (FORBIDDEN | {"spfft_tpu_torch", "portbench"}), f
        assert tops <= {"__future__", "math", "torch", "numpy"}, f
