"""The port's fault seam (``spfft_tpu_torch.faults``) against the JAX
package's (``spfft_tpu.faults``): the same declarations, the same scripts
and seeded rates firing at the same checks, the same classification of
the error corpus (tests/data/runtime_error_corpus.json) and of the port's
own CUDA error texts; a kernel that does not build is never charged to
the device, so the fused kernels' demotion ladder re-raises it."""

import errno
import json
import os
import random
import subprocess

import numpy as np
import pytest
import torch

from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.errors import DeviceError, KernelBuildError
from spfft_tpu_torch.ops import _build, fused_kernel

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean():
    """Both packages disarmed with empty counters and journals, before
    and after every test."""
    def reset():
        for f, o in ((faults, obs), (jfaults, jobs)):
            f.disarm()
            o.GLOBAL_COUNTERS.reset()
            o.reset_recorder()
    reset()
    yield
    reset()


def test_declarations_equal():
    assert faults.SITES == jfaults.SITES
    assert faults.KINDS == jfaults.KINDS
    assert faults.TRANSIENT_MARKERS == jfaults.TRANSIENT_MARKERS
    assert faults.PERSISTENT_DISK_ERRNOS == jfaults.PERSISTENT_DISK_ERRNOS
    assert [t.__name__ for t in faults.REQUEST_ERROR_TYPES] == \
        [t.__name__ for t in jfaults.REQUEST_ERROR_TYPES]


def _fire_pattern(mod, plan, checks):
    """Each check's outcome: None, or (type name, transient,
    device_attributed, errno)."""
    out = []
    for site, dev in checks:
        try:
            plan.check(site, dev)
            out.append(None)
        except mod.InjectedFault as exc:
            out.append((type(exc).__name__, exc.transient,
                        exc.device_attributed, getattr(exc, "errno", None)))
    return out


def _checks(seed, n=200):
    rng = random.Random(seed)
    sites = ["kernel.launch", "plan.build", "exchange.quantize",
             "exchange.collective", "dispatch", "loop", "store.spill"]
    return [(rng.choice(sites), rng.choice([None, 0, 1, 2]))
            for _ in range(n)]


@pytest.mark.parametrize("seed,rate,scope", [
    (0, 0.1, None), (1, 0.5, None), (7, 0.3, "kernel.launch"),
    (11, 0.25, "device:1"), (3, 1.0, "loop"), (5, 0.0, None)])
def test_seeded_rates_replay_the_same_fires(seed, rate, scope):
    checks = _checks(seed)
    tp = faults.FaultPlan(rate=rate, seed=seed, scope=scope)
    jp = jfaults.FaultPlan(rate=rate, seed=seed, scope=scope)
    got = _fire_pattern(faults, tp, checks)
    assert got == _fire_pattern(jfaults, jp, checks)
    assert tp.stats() == jp.stats()
    if rate > 0:
        assert any(got)


SCRIPTS = ["kernel.launch@3", "kernel.launch@*:permanent",
           "store.spill@1:enospc,dispatch@2:poison",
           "device1@2:transient, plan.build@1",
           "device2@*:permanent", "exchange.quantize@1,exchange.quantize@3"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_fire_at_the_same_checks(script):
    checks = _checks(len(script)) + [("store.spill", None),
                                     ("dispatch", 2), ("dispatch", 2)]
    tp = faults.FaultPlan(script=script)
    jp = jfaults.FaultPlan(script=script)
    got = _fire_pattern(faults, tp, checks)
    assert got == _fire_pattern(jfaults, jp, checks)
    assert any(got)
    assert tp.stats() == jp.stats()


@pytest.mark.parametrize("kw", [
    {"script": "nosuch@1"}, {"script": "kernel.launch@0"},
    {"script": "kernel.launch@1:fatal"}, {"script": "kernel.launch"},
    {"rate": 1.5}, {"scope": "device:x"}, {"hang_seconds": -1.0}])
def test_bad_plans_raise_typed_in_both(kw):
    with pytest.raises(jfaults.InvalidParameterError):
        jfaults.FaultPlan(**kw)
    with pytest.raises(sp.InvalidParameterError):
        faults.FaultPlan(**kw)


def test_ambient_arm_counts_and_journal_match():
    """``arm`` / ``check_site`` / ``disarm`` through the ambient hook
    leave the same counters and journal kinds in both packages."""
    for f in (faults, jfaults):
        f.arm(f.FaultPlan(script="kernel.launch@2,obs.capture@1:enospc"))
        assert f.armed() is not None
        for site in ("kernel.launch", "kernel.launch", "obs.capture",
                     "kernel.launch"):
            try:
                f.check_site(site)
            except f.InjectedFault:
                pass
        f.disarm()
        f.check_site("kernel.launch")  # disarmed: a no-op
        assert f.armed() is None
    snap = obs.GLOBAL_COUNTERS.snapshot()
    assert snap == jobs.GLOBAL_COUNTERS.snapshot()
    assert obs.GLOBAL_COUNTERS.get("spfft_faults_injected_total",
                                   site="kernel.launch",
                                   kind="transient") == 1
    assert [e["attrs"] for e in obs.GLOBAL_JOURNAL.snapshot()] == \
        [e["attrs"] for e in jobs.GLOBAL_JOURNAL.snapshot()]


def _corpus():
    path = os.path.join(os.path.dirname(__file__), "data",
                        "runtime_error_corpus.json")
    with open(path) as f:
        return json.load(f)["entries"]


def _build_exc(entry):
    exc_type = {"RuntimeError": RuntimeError, "TimeoutError": TimeoutError,
                "TypeError": TypeError, "ValueError": ValueError,
                "IndexError": IndexError, "KeyError": KeyError,
                "OSError": OSError}[entry["exc_type"]]
    if entry["exc_type"] == "OSError":
        return OSError(entry["errno"], entry["text"])
    return exc_type(entry["text"])


def _verdicts(mod, exc):
    return (mod.is_transient(exc), mod.attributes_device(exc),
            mod.is_persistent_disk_error(exc))


@pytest.mark.parametrize("entry", _corpus(), ids=lambda e: e["name"])
def test_error_corpus_classifies_as_in_jax(entry):
    exc = _build_exc(entry)
    got = _verdicts(faults, exc)
    assert got == _verdicts(jfaults, exc)
    assert got[:2] == (entry["transient"], entry["device_attributed"])


#: the port's own error texts: (name, exception, transient,
#: device-attributed)
PORT_ERRORS = [
    ("cuda_oom", lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.06 GiB is free."), True, True),
    ("cuda_error_oom", lambda: RuntimeError(
        "CUDA error: out of memory\nCUDA kernel errors might be "
        "asynchronously reported at some other API call"), True, True),
    ("launch_refused", lambda: DeviceError(
        "decompress_zdft fft kernel: CUDA error 700 at launch"), False, True),
    ("launch_bounds", lambda: DeviceError(
        "pdft2 cluster kernel: CUDA error 9 at launch"), False, True),
    ("illegal_address", lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"), False,
     True),
    ("nvcc_missing", lambda: KernelBuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "spfft_tpu_torch build from source at first use"), False, False),
    ("nvcc_failed", lambda: KernelBuildError(
        "nvcc failed on csrc/fft.cu (exit 1):\nerror: identifier "
        "\"x\" is undefined"), False, False),
    ("bad_values", lambda: sp.InvalidParameterError(
        "expected 12 frequency values, got shape (3,)"), False, False),
    ("no_device", lambda: DeviceError(
        "no CUDA device: spfft_tpu_torch runs on the GPU"), False, True),
]


@pytest.mark.parametrize("name,make,transient,device", PORT_ERRORS,
                         ids=[e[0] for e in PORT_ERRORS])
def test_port_error_texts_classify(name, make, transient, device):
    exc = make()
    assert faults.is_transient(exc) is transient
    assert faults.attributes_device(exc) is device
    assert not faults.is_persistent_disk_error(exc)


def test_every_cuda_marker_has_an_exemplar():
    texts = [str(make()) for _, make, _, _ in PORT_ERRORS]
    for marker in faults.CUDA_TRANSIENT_MARKERS:
        assert any(marker in t for t in texts), marker


def test_disk_errors_classify_as_in_jax():
    for code in (errno.ENOSPC, errno.EROFS, errno.EIO, errno.EINTR):
        exc = OSError(code, os.strerror(code))
        assert _verdicts(faults, exc) == _verdicts(jfaults, exc)
    full = faults.InjectedDiskFull("x")
    assert isinstance(full, OSError) and full.errno == errno.ENOSPC
    assert faults.is_persistent_disk_error(full)
    assert not faults.is_transient(full)
    assert not faults.attributes_device(full)


def test_a_failed_kernel_build_is_typed_and_not_the_devices(monkeypatch,
                                                           tmp_path):
    """With no ``nvcc`` the build raises KernelBuildError, a DeviceError
    the classifier does not charge to the device."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_library_path",
                        lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if "nvcc" in str(p)
                        else real_exists(p))
    with pytest.raises(KernelBuildError) as info:
        _build.build(("fft.cu",))
    assert isinstance(info.value, DeviceError)
    assert not faults.attributes_device(info.value)
    assert not faults.is_transient(info.value)


class _StuckNvcc:
    """An ``nvcc`` process that never finishes."""

    def __init__(self, *args, **kwargs):
        self.killed = False

    def communicate(self, timeout=None):
        raise subprocess.TimeoutExpired("nvcc", timeout)

    def poll(self):
        return None if not self.killed else -9

    def kill(self):
        self.killed = True

    def wait(self):
        return -9


class _NoEntries:
    """A loaded library that has no entry at all."""


def _failing_build(kind, monkeypatch, tmp_path):
    """Make the next ``_build.function("fused_fft.cu", ...)`` fail as
    ``kind``: nvcc running past its limit, a library that does not load,
    or a library without the entry. Returns the type of the cause."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_library_path",
                        lambda name: tmp_path / f"{name}.so")
    if kind == "timeout":
        monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(_build.subprocess, "Popen", _StuckNvcc)
        return subprocess.TimeoutExpired
    if kind == "bad_library":
        (tmp_path / "fused_fft.cu.so").write_bytes(b"not a shared library")
        return OSError
    monkeypatch.setattr(_build, "_libs", {"fused_fft.cu": _NoEntries()})
    return AttributeError


@pytest.mark.parametrize("kind", ["timeout", "bad_library", "no_entry"])
def test_every_build_failure_is_a_build_error(kind, monkeypatch, tmp_path):
    """nvcc past its limit, a library that does not load and an entry it
    lacks each raise KernelBuildError with the cause chained, which the
    classifier does not charge to the device."""
    cause = _failing_build(kind, monkeypatch, tmp_path)
    with pytest.raises(KernelBuildError) as info:
        _build.function("fused_fft.cu", "spfft_absent_f64", [])
    assert isinstance(info.value.__cause__, cause)
    assert not faults.attributes_device(info.value)
    assert not faults.is_transient(info.value)
    if kind == "timeout":
        assert obs.GLOBAL_COUNTERS.get("spfft_compile_events_total",
                                       kind="kernel_build") == 1


def _sphere_plan(**kw):
    g = np.arange(8)
    t = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    t = t[(t ** 2).sum(1) <= 25]
    return sp.make_local_plan(sp.TransformType.C2C, 8, 8, 8, t,
                              device="cpu", **kw)


def test_the_ladder_never_demotes_a_build_failure(monkeypatch):
    """A fused kernel whose library does not build raises through the
    demotion ladder untouched: no demotion, no counter."""
    plan = _sphere_plan()
    vals = np.ones((plan.index_plan.num_values, 2), np.float32)

    def broken(*a, **k):
        raise KernelBuildError("nvcc failed on csrc/fused_fft.cu (exit 1)")

    monkeypatch.setattr(fused_kernel, "decompress_zdft", broken)
    with pytest.raises(KernelBuildError):
        plan.backward(vals)
    assert plan.fused_demotions() == {}
    assert obs.GLOBAL_COUNTERS.get("spfft_fused_demotions_total",
                                   which="dec") == 0


@pytest.mark.parametrize("kind", ["timeout", "bad_library", "no_entry"])
def test_the_ladder_never_demotes_a_library_failure(kind, monkeypatch,
                                                    tmp_path):
    """A fused kernel whose library runs past the build's limit, does not
    load or lacks its entry raises through the ladder untouched."""
    plan = _sphere_plan()
    vals = np.ones((plan.index_plan.num_values, 2), np.float32)
    cause = _failing_build(kind, monkeypatch, tmp_path)

    def launch(*a, **k):
        _build.function("fused_fft.cu", "spfft_absent", [])

    monkeypatch.setattr(fused_kernel, "decompress_zdft", launch)
    with pytest.raises(KernelBuildError) as info:
        plan.backward(vals)
    assert isinstance(info.value.__cause__, cause)
    assert plan.fused_demotions() == {}
    assert obs.GLOBAL_COUNTERS.get("spfft_fused_demotions_total",
                                   which="dec") == 0


def test_the_ladder_demotes_a_launch_failure(monkeypatch):
    """A CUDA launch error (a DeviceError charged to the device) demotes
    the direction, and the call is served by the two-kernel route."""
    plan = _sphere_plan()
    ref = _sphere_plan(fused=False)
    vals = np.random.default_rng(0).standard_normal(
        (plan.index_plan.num_values, 2)).astype(np.float32)

    def broken(*a, **k):
        raise DeviceError("decompress_zdft fft kernel: CUDA error 700 at "
                          "launch")

    monkeypatch.setattr(fused_kernel, "decompress_zdft", broken)
    assert torch.equal(plan.backward(vals), ref.backward(vals))
    dem = plan.fused_demotions()
    assert set(dem) == {"dec"} and "DeviceError" in dem["dec"]["reason"]
    assert obs.GLOBAL_COUNTERS.get("spfft_fused_demotions_total",
                                   which="dec") == 1
    assert [e["kind"] for e in obs.GLOBAL_JOURNAL.snapshot()] == \
        ["fused.demote"]
