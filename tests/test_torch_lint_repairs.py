"""The behaviour of the code that the port's lint findings were repaired
in: the ``exchange.*`` fault seams of the distributed plan (now consulted
by literal site name) in the JAX package's order, ``ops._build.function``
reading the library under the build's one acquisition of its lock, and
the C ABI's handle table under the reentrant ``_call_lock``."""

import threading

import numpy as np
import pytest
import torch

import spfft_tpu
from spfft_tpu import faults as jfaults
from spfft_tpu import parallel as jpar
from spfft_tpu.control import config as jcfg

import spfft_tpu_torch as sp
from spfft_tpu_torch import capi_bridge, faults
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.errors import ErrorCode, KernelBuildError
from spfft_tpu_torch.ops import _build

from test_distributed import split_by_sticks, split_planes
from test_util import hermitian_triplets, random_sparse_triplets


@pytest.fixture(autouse=True)
def _clean():
    for f, c in ((faults, tcfg), (jfaults, jcfg)):
        f.disarm()
        c.set_global_config(None)
    yield
    for f, c in ((faults, tcfg), (jfaults, jcfg)):
        f.disarm()
        c.set_global_config(None)


def _recorder(f):
    """A fault plan of package ``f`` that fires nothing and records every
    site it is asked about, in order."""

    class Recorder(f.FaultPlan):
        def __init__(self):
            super().__init__()
            self.sites = []

        def check(self, site, device=None):
            self.sites.append(site)
            super().check(site, device)

    return Recorder()


def _seam_orders(kind, k):
    """The ``exchange.*`` sites each package's distributed plan consults
    over its first backward, then its first forward, then a second
    pair (which consults none: the seams fire once per executable)."""
    dims = (8, 8, 8)
    rng = np.random.default_rng(11)
    trip = (hermitian_triplets(rng, dims) if kind == "r2c"
            else random_sparse_triplets(rng, dims))
    parts = split_by_sticks(trip, dims, [1, 1])
    planes = split_planes(8, [1, 1])
    jtype = getattr(spfft_tpu.TransformType, kind.upper())
    ttype = getattr(sp.TransformType, kind.upper())
    jp = jpar.make_distributed_plan(jtype, *dims, parts, planes,
                                    mesh=jpar.make_mesh(2),
                                    precision="single", overlap_chunks=k)
    tp = sp.make_distributed_plan(ttype, *dims, parts, planes, device="cpu",
                                  overlap_chunks=k)
    vals = [(rng.standard_normal(len(p)) + 1j * rng.standard_normal(len(p)))
            .astype(np.complex64) for p in parts]
    orders = []
    for f, plan, host in ((jfaults, jp, np.asarray),
                          (faults, tp, torch.as_tensor)):
        rec = _recorder(f)
        f.arm(rec)
        try:
            for _ in range(2):
                space = plan.backward(vals)
                plan.forward(host(np.asarray(space)))
        finally:
            f.disarm()
        orders.append([s for s in rec.sites if s.startswith("exchange.")])
    return orders


@pytest.mark.parametrize("kind", ["c2c", "r2c"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_exchange_seam_order_equals_jax(kind, k):
    """K = 1: pack, collective, unpack (backward), then pack, collective
    (forward); K > 1: chunk, pack per chunk, then the backward's unpack
    — each package consults its sites in the same order, once."""
    jax_order, port_order = _seam_orders(kind, k)
    assert port_order == jax_order
    if k == 1:
        assert port_order == ["exchange.pack", "exchange.collective",
                              "exchange.unpack", "exchange.pack",
                              "exchange.collective"]
    else:
        assert port_order == (["exchange.chunk", "exchange.pack"] * k
                              + ["exchange.unpack"]
                              + ["exchange.chunk", "exchange.pack"] * k)


class _CountingLock:
    """A lock that counts its acquisitions."""

    def __init__(self):
        self._lock = threading.Lock()
        self.acquisitions = 0

    def __enter__(self):
        self._lock.acquire()
        self.acquisitions += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()


class _Library:
    """A loaded library with one entry."""

    def __init__(self):
        self.spfft_probe = lambda *args: 0


def test_function_reads_the_library_under_one_lock_acquisition(
        monkeypatch):
    """``function`` of a loaded library takes ``_build._lock`` once, as
    ``build`` alone did before, and types the entry; an entry the
    library lacks is a KernelBuildError."""
    lock = _CountingLock()
    monkeypatch.setattr(_build, "_lock", lock)
    monkeypatch.setattr(_build, "_libs", {"fft.cu": _Library()})
    fn = _build.function("fft.cu", "spfft_probe", [])
    assert lock.acquisitions == 1
    assert fn.restype is not None and fn.argtypes == []
    assert _build.build(("fft.cu",)) == {}
    assert lock.acquisitions == 2
    with pytest.raises(KernelBuildError):
        _build.function("fft.cu", "spfft_absent", [])
    assert lock.acquisitions == 3


def test_capi_handle_table_under_the_reentrant_call_lock():
    """The handle table is read and written under ``_call_lock``, which
    the C entry wrapper already holds: the lock is reentrant, a handle
    registers, resolves and is destroyed inside a guarded call, and an
    unknown handle answers INVALID_HANDLE."""
    assert capi_bridge._call_lock.acquire(blocking=False)
    try:
        assert capi_bridge._call_lock.acquire(blocking=False)
        capi_bridge._call_lock.release()
    finally:
        capi_bridge._call_lock.release()

    @capi_bridge._guarded
    def roundtrip(plan):
        pid = capi_bridge._register(plan)
        assert capi_bridge._get_plan(pid) is plan
        return pid

    code, pid = roundtrip(object())
    assert code == int(ErrorCode.SUCCESS) and pid in capi_bridge._plans
    assert capi_bridge.plan_destroy(pid) == (int(ErrorCode.SUCCESS), 0)
    assert pid not in capi_bridge._plans
    assert capi_bridge.plan_destroy(pid) == (
        int(ErrorCode.INVALID_HANDLE), 0)


def test_capi_handle_table_waits_for_a_call_in_flight():
    """A thread's handle-table access waits while another thread's C call
    holds ``_call_lock``."""
    pid = capi_bridge._register(object())
    seen = []
    capi_bridge._call_lock.acquire()
    try:
        t = threading.Thread(
            target=lambda: seen.append(capi_bridge.plan_destroy(pid)))
        t.start()
        t.join(0.2)
        assert t.is_alive() and seen == []
    finally:
        capi_bridge._call_lock.release()
    t.join(10)
    assert seen == [(int(ErrorCode.SUCCESS), 0)]
