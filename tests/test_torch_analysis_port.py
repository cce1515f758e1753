"""The port's lint engine over the port: ``python -m
spfft_tpu_torch.analysis`` exits 0 on ``spfft_tpu_torch/`` with its own
docs (``docs_torch/``), every waiver carries a reason, the lock-order
graph keeps its known edges, and the one departure from the JAX engine
is exactly the C entry names of the kernel libraries."""

import json
import os
import subprocess
import sys

import pytest

from spfft_tpu import analysis as janalysis
from spfft_tpu_torch import analysis as tanalysis
from spfft_tpu_torch.control.config import KNOB_SPECS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PACKAGE = os.path.join(REPO, "spfft_tpu_torch")


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """The JSON report of ``python -m spfft_tpu_torch.analysis`` run as
    a process with no arguments but the report's path."""
    out = tmp_path_factory.mktemp("analysis") / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "spfft_tpu_torch.analysis", "--json",
         str(out), "-q"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
    return json.loads(out.read_text())


def test_port_package_analysis_is_clean(report):
    assert report["ok"] is True
    assert report["summary"]["errors"] == 0
    assert report["summary"]["warnings"] == 0
    assert report["checkers"] == list(tanalysis.CHECKERS)
    for waiver in report["waivers"]:
        assert waiver["reason"], waiver


def test_port_waivers_are_the_known_ones(report):
    """The port's waivers: the six API-parity error classes, the
    ``store.aot`` site of a tier the port does not have, and the
    executor's two racy reads (the JAX package waives the same two)."""
    got = sorted((w["checker"], w["path"], w["message"].split(" ")[2]
                  if w["checker"] == "error-taxonomy" else w["line"] * 0)
                 for w in report["waivers"])
    classes = ("AllocationError", "DeviceAllocationError", "DeviceFFTError",
               "DeviceSupportError", "DistributedSupportError",
               "InternalError")
    assert got == sorted(
        [("error-taxonomy", "errors.py", c) for c in classes]
        + [("fault-sites", "faults.py", 0)]
        + [("lock-discipline", "serve/executor.py", 0)] * 2)
    for w in report["waivers"]:
        assert "XLA" not in w["reason"], w


def test_port_lock_hierarchy_acyclic_with_known_edges(report):
    """Regression pin of the port's lock hierarchy (as the JAX package's
    is pinned): the executor's cv, pool and staging locks are outer to
    the config, tracer and registry locks, the lazy global-config boot
    nests config / obs locks under its module lock, the membership
    coordinator and the store's manifest lock record under theirs, and
    the graph has no cycle."""
    edges = report["extras"]["lock_order_edges"]
    for expected in (
            "ServeExecutor._cv -> Tracer._lock",
            "ServeExecutor._cv -> ServeConfig._lock",
            "ServeExecutor._pool_lock -> ServeConfig._lock",
            "ServeExecutor._staging_lock -> PlanRegistry._lock",
            "config.py::_GLOBAL_LOCK -> ServeConfig._lock",
            "config.py::_GLOBAL_LOCK -> Counters._lock",
            "ViewCoordinator._lock -> Counters._lock",
            "store.py::_MANIFEST_LOCK -> PlanArtifactStore._lock",
            "recorder.py::_capture_lock -> EventJournal._lock"):
        assert any(e.startswith(expected + " ") for e in edges), \
            (expected, edges)
    assert not [f for f in report["findings"]
                if f["checker"] == "lock-order"]


def test_port_tree_counter_departure_is_the_c_entries():
    """On the port's tree the JAX engine's counter-registry reads the 14
    C entry names passed to ``_build.function`` / ``_build.entry`` as
    undeclared series; the port's engine reports none of them, and
    nothing else differs."""
    jax_report, port_report = (
        pkg.run_analysis(root=PORT_PACKAGE,
                         checkers=["counter-registry"]).to_dict()
        for pkg in (janalysis, tanalysis))
    assert port_report["findings"] == []
    assert port_report["waivers"] == jax_report["waivers"] == []
    got = sorted((f["path"], f["line"], f["message"].split("'")[1])
                 for f in jax_report["findings"])
    assert len(got) == 14
    assert {path for path, _, _ in got} == {
        "ops/dft_kernel.py", "ops/fused_kernel.py", "ops/gather_kernel.py",
        "ops/wire_kernel.py"}
    assert {name for _, _, name in got} == {
        "spfft_fft_long_whole_n", "spfft_fft_long", "spfft_bluestein",
        "spfft_rfft_stage", "spfft_fft_stage", "spfft_dft_stage",
        "spfft_fft_plane", "spfft_decompress_zdft_fft",
        "spfft_decompress_zdft", "spfft_zdft_compress_fft",
        "spfft_zdft_compress", "spfft_gather", "spfft_wire_quantize",
        "spfft_wire_dequantize"}
    assert all("not declared" in f["message"]
               for f in jax_report["findings"])
    assert port_report["extras"]["declared_metrics"] == \
        jax_report["extras"]["declared_metrics"]


def test_port_docs_cover_every_class_and_knob():
    """The port's own docs (``docs_torch/``) carry the taxonomy and the
    knob table: error-taxonomy and knob-registry read them and find
    nothing, and neither reads ``docs/``."""
    errors_docs, knob_doc = tanalysis.docs_paths(PORT_PACKAGE, None)
    assert errors_docs and all(
        os.sep + tanalysis.PORT_DOCS + os.sep in p for p in errors_docs)
    assert knob_doc.endswith(os.path.join(tanalysis.PORT_DOCS,
                                          "control_plane.md"))
    report = tanalysis.run_analysis(
        root=PORT_PACKAGE, checkers=["error-taxonomy", "knob-registry"])
    assert report.ok(), report.text()
    assert report.extras["knobs"] == len(KNOB_SPECS)
