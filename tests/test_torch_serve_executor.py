"""The port's batching executor (``spfft_tpu_torch.serve.executor``)
against its own serial calls and the JAX package's executor on the CPU.

The load-bearing test is the concurrency fuzz: 8 submitter threads x
mixed signatures (C2C and R2C, single and double) x mixed priorities x
deadlines with aggressive pinning (``pin_after=1``) and the pow2 ladder.
Every result must equal the port plan's serial ``backward`` /
``forward`` of that request BIT FOR BIT, and lie within the accuracy
contract of the JAX executor's result on the same requests: 1e-6
relative l2 in single precision, ``predicted_rel_error("double", n)`` in
double. The flow-control paths (``QueueFullError``,
``DeadlineExpiredError``), pinning after ``pin_after`` and the
``ServeMetrics`` keys behave as the JAX package's on the same request
sequences. On the CPU the plan's kernels run their plain versions (only
a CUDA tensor launches a kernel); the staging buffer is a plain host
tensor there (pinned on the card).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from spfft_tpu import TransformType as JTT
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg
from spfft_tpu.serve import PlanRegistry as JRegistry
from spfft_tpu.serve import ServeExecutor as JExecutor

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.errors import (DistributedPlanUnsupportedError,
                                    InvalidParameterError, ServeError)
from spfft_tpu_torch.ops import _build
from spfft_tpu_torch.serve import (PlanRegistry, ServeExecutor,
                                   ServeMetrics, percentile)

from test_util import hermitian_triplets, random_sparse_triplets

torch.set_num_threads(2)

DIMS = (12, 13, 11)
R2C_DIMS = (12, 10, 9)
SINGLE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for f, o, c in ((faults, obs, tcfg), (jfaults, jobs, jcfg)):
            f.disarm()
            o.GLOBAL_COUNTERS.reset()
            c.set_global_config(None)
    reset()
    yield
    reset()


SPECS = {  # name -> (transform, dims, seed, precision)
    "c2c": ("c2c", DIMS, 1, "single"),
    "c2c2": ("c2c", DIMS, 2, "single"),
    "r2c": ("r2c", R2C_DIMS, 3, "single"),
    "c2c_f64": ("c2c", DIMS, 4, "double"),
}


def _triplets(kind, dims, seed):
    rng = np.random.default_rng(seed)
    return (hermitian_triplets(rng, dims) if kind == "r2c"
            else random_sparse_triplets(rng, dims))


def _registries(names):
    """A port registry (plans on the CPU) and a JAX registry over the
    same triplets; ``{name: (port signature, JAX signature)}``."""
    treg, jreg = PlanRegistry(store=False), JRegistry(store=False)
    sigs = {}
    for name in names:
        kind, dims, seed, precision = SPECS[name]
        trip = _triplets(kind, dims, seed)
        tsig, _ = treg.get_or_build(sp.TransformType(kind), *dims, trip,
                                    precision=precision, device="cpu")
        jsig, _ = jreg.get_or_build(JTT(kind), *dims, trip,
                                    precision=precision)
        assert tsig.__dict__ == jsig.__dict__
        sigs[name] = (tsig, jsig)
    return treg, jreg, sigs


def _values(plan, rng):
    n = plan.index_plan.num_values
    dt = np.float32 if plan.precision == "single" else np.float64
    return rng.uniform(-1, 1, (n, 2)).astype(dt)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _tol(plan):
    if plan.precision == "single":
        return SINGLE_TOL
    p = plan.index_plan
    return sp.predicted_rel_error("double", max(p.dim_x, p.dim_y, p.dim_z))


def _requests(treg, sigs, count, rng):
    """``count`` mixed requests: (name, kind, scaling, priority, timeout,
    payload, serial oracle)."""
    names = sorted(sigs)
    out = []
    for _ in range(count):
        name = names[int(rng.integers(len(names)))]
        plan = treg.get(sigs[name][0])
        v = _values(plan, rng)
        prio = "high" if rng.random() < 0.3 else "normal"
        timeout = 120.0 if rng.random() < 0.4 else None
        if rng.random() < 0.5:
            out.append((name, "backward", sp.Scaling.NONE, prio, timeout, v,
                        plan.backward(v)))
        else:
            space = plan.backward(v).numpy()
            scl = sp.Scaling.FULL if rng.random() < 0.5 else sp.Scaling.NONE
            out.append((name, "forward", scl, prio, timeout, space,
                        plan.forward(space, scl)))
    return out


def _jax_results(jreg, sigs, requests):
    """The JAX executor's results on the same requests (staged, then
    drained)."""
    ex = JExecutor(jreg, autostart=False, batch_window=0.0, pin_after=1)
    futs = [ex.submit(sigs[name][1], payload, kind, scaling=scl.value,
                      priority=prio)
            for name, kind, scl, prio, _, payload, _ in requests]
    ex._drain_once()
    out = [np.asarray(f.result(timeout=120)) for f in futs]
    ex.close()
    return out


def test_concurrency_fuzz_bit_exact_and_within_contract_of_jax():
    treg, jreg, sigs = _registries(["c2c", "c2c2", "r2c", "c2c_f64"])
    rng = np.random.default_rng(42)
    requests = _requests(treg, sigs, 72, rng)
    ex = ServeExecutor(treg, autostart=False, batch_window=0.001,
                       pin_after=1)
    futures = [None] * len(requests)
    errors = []

    def submit(i):
        name, kind, scl, prio, timeout, payload, _ = requests[i]
        futures[i] = ex.submit(sigs[name][0], payload, kind, scaling=scl,
                               timeout=timeout, priority=prio)

    # stage the first third (full same-signature buckets form); then 8
    # threads race the rest against the draining dispatcher
    for i in range(24):
        submit(i)

    def submitter(indices):
        for i in indices:
            try:
                submit(i)
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

    threads = [threading.Thread(target=submitter,
                                args=(range(24 + k, len(requests), 8),))
               for k in range(8)]
    # a short switch interval makes the threads interleave inside the
    # executor's bookkeeping, where a lost update would show
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ex.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    got = [futures[i].result(timeout=120) for i in range(len(requests))]
    ex.close()
    for i, (name, kind, scl, prio, _, _, oracle) in enumerate(requests):
        assert torch.equal(got[i], oracle), \
            f"request {i} ({name} {kind} {prio}) differs from its serial call"
    snap = ex.metrics.snapshot(treg)
    assert snap["completed"] == len(requests) and snap["failed"] == 0
    assert snap["completed_by_class"]["high"] > 0
    assert ex.metrics.fused_batches >= 1
    assert ex.metrics.max_fused_batch_size >= 2
    jgot = _jax_results(jreg, sigs, requests)
    for i, (name, kind, *_rest) in enumerate(requests):
        plan = treg.get(sigs[name][0])
        rel = _rel(got[i].numpy(), jgot[i])
        assert rel <= _tol(plan), (i, name, kind, rel)


def test_staged_bucket_runs_batched_and_returns_its_buffer():
    treg, _, sigs = _registries(["c2c"])
    sig = sigs["c2c"][0]
    plan = treg.get(sig)
    rng = np.random.default_rng(7)
    vals = [_values(plan, rng) for _ in range(8)]
    ex = ServeExecutor(treg, autostart=False, batch_window=0.0)
    futs = [ex.submit(sig, v) for v in vals]
    ex._drain_once()
    for f, v in zip(futs, vals):
        assert torch.equal(f.result(timeout=30), plan.backward(v))
    assert ex.metrics.fused_batches == 1
    assert ex.metrics.max_fused_batch_size == 8
    # one buffer of max_batch rows checked out for the shard and back on
    # its list
    assert [len(v) for v in ex._staging.values()] == [1]
    buf, events = next(iter(ex._staging.values()))[0]
    assert tuple(buf.shape) == (ex._max_batch,) \
        + plan.batch_row_template("values")[0]
    assert events == []  # the CPU needs no copy to a card
    # smaller buckets stage into its leading rows: still that one buffer
    _waves(ex, plan, sig, [3, 5, 2], rng)
    assert [len(v) for v in ex._staging.values()] == [1]
    assert next(iter(ex._staging.values()))[0][0] is buf
    ex.close()
    assert ex._staging == {}


def test_evicted_signature_holds_no_staging_buffer():
    """A signature the registry evicts lets its staging buffers go; the
    signatures it keeps hold theirs."""
    treg = PlanRegistry(store=False, max_plans=2)
    sigs = {}
    for name in ("c2c", "c2c2"):
        kind, dims, seed, precision = SPECS[name]
        sigs[name], _ = treg.get_or_build(
            sp.TransformType(kind), *dims, _triplets(kind, dims, seed),
            precision=precision, device="cpu")
    ex = ServeExecutor(treg, autostart=False, batch_window=0.0)
    rng = np.random.default_rng(9)
    for name in ("c2c", "c2c2"):
        _waves(ex, treg.get(sigs[name]), sigs[name], [4], rng)
    assert sorted(k[0] == sigs["c2c"] for k in ex._staging) \
        == [False, True]
    kind, dims, seed, precision = SPECS["r2c"]
    treg.get_or_build(sp.TransformType(kind), *dims,
                      _triplets(kind, dims, seed), precision=precision,
                      device="cpu")  # the third plan evicts c2c
    assert sigs["c2c"] not in treg and sigs["c2c2"] in treg
    assert [k[0] for k in ex._staging] == [sigs["c2c2"]]
    ex.close()
    assert ex._staging == {}


def test_forward_of_returned_slabs_and_device_payloads():
    """Forward requests of the slabs backward requests returned (tensors,
    the list path of the staging) are bit for bit the serial calls."""
    treg, _, sigs = _registries(["r2c"])
    sig = sigs["r2c"][0]
    plan = treg.get(sig)
    rng = np.random.default_rng(8)
    vals = [_values(plan, rng) for _ in range(5)]
    with ServeExecutor(treg, batch_window=0.002) as ex:
        spaces = [f.result(30) for f in [ex.submit(sig, v) for v in vals]]
        outs = [f.result(30) for f in [
            ex.submit(sig, s, "forward", scaling=sp.Scaling.FULL)
            for s in spaces]]
    for v, s, o in zip(vals, spaces, outs):
        assert torch.equal(s, plan.backward(v))
        assert torch.equal(o, plan.forward(plan.backward(v),
                                           sp.Scaling.FULL))


def _waves(ex, plan, sig, sizes, rng):
    for size in sizes:
        vals = [_values(plan, rng) for _ in range(size)]
        futs = [ex.submit(sig, v) for v in vals]
        ex._drain_once()
        for f, v in zip(futs, vals):
            got = f.result(timeout=30)
            if isinstance(got, torch.Tensor):
                assert torch.equal(got, plan.backward(v))


@pytest.mark.parametrize("sizes,pin_after,max_pinned", [
    ([5, 5, 5, 5, 5], 3, 4),
    ([3, 5, 3, 5, 3, 5], 3, 4),
    ([5, 5, 5], 0, 4),
    ([3, 5, 6, 7], 1, 2),
])
def test_pinning_and_ladder_counters_equal_the_jax_executor(
        sizes, pin_after, max_pinned):
    treg, jreg, sigs = _registries(["c2c"])
    tsig, jsig = sigs["c2c"]
    out = []
    for mod, reg, sig, ctor in ((sp, treg, tsig, ServeExecutor),
                                (None, jreg, jsig, JExecutor)):
        ex = ctor(reg, autostart=False, batch_window=0.0,
                  pin_after=pin_after, max_pinned_shapes=max_pinned)
        _waves(ex, reg.get(sig), sig, sizes, np.random.default_rng(21))
        ex.close()
        out.append((ex.metrics.padded_rows, ex.metrics.pinned_batches,
                    ex.pinned_shapes(sig), ex.metrics.fused_batches))
    assert out[0] == out[1]


def _flow(ctor, reg, sig, plan):
    """Queue-full backpressure, then a deadline that expires in the
    queue: the outcomes by type name and the counters."""
    ex = ctor(reg, autostart=False, max_queue=2)
    rng = np.random.default_rng(3)
    f1 = ex.submit(sig, _values(plan, rng))
    f2 = ex.submit(sig, _values(plan, rng), timeout=0.01)
    outcome = []
    try:
        ex.submit(sig, _values(plan, rng))
    except Exception as exc:
        outcome.append(type(exc).__name__)
    time.sleep(0.03)  # f2's deadline passes in the queue
    f3 = ex.submit(sig, _values(plan, rng))  # reaps f2, then fits
    ex._drain_once()
    for f in (f1, f2, f3):
        try:
            f.result(timeout=30)
            outcome.append("ok")
        except Exception as exc:
            outcome.append(type(exc).__name__)
    ex.close()
    snap = ex.metrics.snapshot()
    h = snap["health"]
    return outcome, (snap["rejected_queue_full"], snap["expired_deadline"],
                     h["purged_expired"], snap["completed"], snap["failed"])


def test_queue_full_and_deadline_behave_as_in_the_jax_package():
    treg, jreg, sigs = _registries(["c2c"])
    tsig, jsig = sigs["c2c"]
    got = _flow(ServeExecutor, treg, tsig, treg.get(tsig))
    want = _flow(JExecutor, jreg, jsig, jreg.get(jsig))
    assert got == want
    assert got[0] == ["QueueFullError", "ok", "DeadlineExpiredError", "ok"]


def test_metrics_keys_equal_the_jax_package():
    treg, jreg, sigs = _registries(["c2c"])
    snaps = []
    for reg, sig, ctor in ((treg, sigs["c2c"][0], ServeExecutor),
                           (jreg, sigs["c2c"][1], JExecutor)):
        with ctor(reg, batch_window=0.0) as ex:
            plan = reg.get(sig)
            rng = np.random.default_rng(1)
            for f in [ex.submit(sig, _values(plan, rng)) for _ in range(3)]:
                f.result(timeout=30)
        snaps.append((ex.metrics.snapshot(reg), ex.metrics.signals(),
                      ex.health()))
    (ts, tsig_, th), (js, jsig_, jh) = snaps
    assert set(ts) == set(js)
    for key in ("health", "overhead_seconds", "latency_seconds",
                "queue_wait_seconds", "device_execute_seconds",
                "latency_seconds_by_class", "registry"):
        assert set(ts[key]) == set(js[key]), key
    assert set(tsig_) == set(jsig_)
    assert set(th) == set(jh)
    assert set(th["config"]) == set(jh["config"])
    assert ts["completed"] == js["completed"] == 3


def test_percentile_and_reservoir():
    assert percentile([], 50) == 0.0
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    m = ServeMetrics(latency_window=4)
    for i in range(10):
        m.record_request_done(float(i))
    assert m.snapshot()["latency_count"] == 4
    assert m.latency_percentiles()["p50"] == 7.0


def test_serial_degradation_pool_and_typed_rejections():
    treg, _, sigs = _registries(["c2c", "c2c_f64"])
    sig = sigs["c2c"][0]
    plan = treg.get(sig)
    rng = np.random.default_rng(4)
    vals = [_values(plan, rng) for _ in range(4)]
    # batching off: serial buckets; a pool of two host slots
    ex = ServeExecutor(treg, autostart=False, batching=False,
                       devices=["cpu", "cpu"])
    futs = [ex.submit(sig, v) for v in vals]
    ex._drain_once()
    for f, v in zip(futs, vals):
        assert torch.equal(f.result(timeout=30), plan.backward(v))
    assert ex.metrics.fused_batches == 0
    assert ex.metrics.snapshot()["serial_batches"] >= 1
    with pytest.raises(InvalidParameterError):
        ex.submit(sig, vals[0], priority="urgent")
    with pytest.raises(InvalidParameterError):
        ex.submit(sigs["c2c"][1], vals[0])  # the JAX package's signature
    ex.close()
    with pytest.raises(ServeError):
        ex.submit(sig, vals[0])

    class _Dist:
        pass
    treg.put(sigs["c2c_f64"][0], plan)
    treg._store[sigs["c2c_f64"][0]] = (_Dist(), 0)
    with ServeExecutor(treg) as ex2:
        with pytest.raises(DistributedPlanUnsupportedError):
            ex2.submit(sigs["c2c_f64"][0], vals[0])


def test_prewarm_runs_every_ladder_shape():
    treg, _, sigs = _registries(["c2c"])
    sig = sigs["c2c"][0]
    plan = treg.get(sig)
    ex = ServeExecutor(treg, autostart=False, max_batch=8)
    calls = []
    real = plan.backward_batched

    def counted(batch, device=None):
        calls.append(len(batch))
        return real(batch, device=device)

    plan.backward_batched = counted
    try:
        ex.prewarm(sig, batch_sizes=(3,))
    finally:
        del plan.backward_batched
    assert sorted(calls) == [2, 3, 4, 8]
    assert obs.GLOBAL_COUNTERS.get("spfft_compile_events_total",
                                   kind="prewarm") == 1
    ex.close()


def test_concurrent_kernel_builds_run_nvcc_once(monkeypatch, tmp_path):
    """The pin-prewarm thread and the dispatcher can both reach the first
    launch of a kernel source: ``ops._build``'s lock lets one ``nvcc``
    run and the other caller load its library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_log", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    runs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            runs.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self, timeout=None):
            time.sleep(0.2)
            with open(self.out, "wb") as f:
                f.write(b"lib")
            return "ptxas info: 0 bytes spill", None

        def poll(self):
            return 0

    loaded = []
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or object())
    got = {}

    def caller(name):
        got[name] = _build.build(("fft.cu",))

    threads = [threading.Thread(target=caller, args=(n,), name=n)
               for n in ("spfft-serve-pin-prewarm",
                         "spfft-serve-dispatcher")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert len(runs) == 1 and len(loaded) == 1
    assert sorted(len(v) for v in got.values()) == [0, 1]
    assert obs.GLOBAL_COUNTERS.get("spfft_compile_events_total",
                                   kind="kernel_build") == 1
