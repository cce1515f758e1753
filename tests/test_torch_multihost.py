"""The port's plan-time multi-process protocol
(``spfft_tpu_torch.parallel.multihost``) against the JAX package's
(``spfft_tpu.parallel.multihost``), in one process.

Every case of tests/test_multihost.py runs for both packages through the
injectable ``(allgather, process_count, process_index)`` collective of a
threaded stub world (one thread per simulated process, a lockstep
allgather): each process's outcome — the plan, or the error's class and
message — must be the same in both, and the port's plans equal the
single-process build. ``plan_fingerprint`` is byte for byte the JAX
package's on the same plans (C2C and R2C, storage and centered indices,
even, uneven and empty shards). The same protocol over real
``torch.distributed`` ranks is tests/test_torch_ranks.py's.
"""

import threading

import numpy as np
import pytest

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu.parallel import multihost as jmh

import spfft_tpu_torch as sp
from spfft_tpu_torch import parallel as tpar
from spfft_tpu_torch.parallel import multihost as tmh

from test_util import center_triplets, random_sparse_triplets

#: each package's module, its build_distributed_plan and its TransformType
PACKAGES = {"jax": (jmh, jpar.build_distributed_plan,
                    spfft_tpu.TransformType),
            "port": (tmh, tpar.build_distributed_plan, sp.TransformType)}


class StubWorld:
    """A P-process world for the injectable collective: each simulated
    process runs on its own thread; ``allgather`` is a barrier-synchronised
    stack of every process's contribution (tests/test_multihost.py's)."""

    def __init__(self, num_processes: int):
        self.num_processes = num_processes
        self._barrier = threading.Barrier(num_processes, timeout=30)
        self._slots = [None] * num_processes

    def collective(self, process_index: int):
        def allgather(x):
            self._slots[process_index] = np.asarray(x)
            self._barrier.wait()
            out = np.stack([np.asarray(s) for s in self._slots])
            self._barrier.wait()
            return out
        return (allgather, self.num_processes, process_index)

    def run(self, fn):
        results = [None] * self.num_processes

        def worker(p):
            try:
                results[p] = ("ok", fn(p, self.collective(p)))
            except Exception as e:  # noqa: BLE001 - surfaced to the test
                results[p] = ("err", e)

        threads = [threading.Thread(target=worker, args=(p,))
                   for p in range(self.num_processes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        return results


def _split(rng, dims, shards, trip=None):
    """Whole z-sticks split at random over ``shards``."""
    trip = random_sparse_triplets(rng, dims) if trip is None else trip
    keys = trip[:, 0] * dims[1] + trip[:, 1]
    uniq = np.unique(keys)
    assign = rng.integers(0, shards, len(uniq))
    return [trip[np.isin(keys, uniq[assign == s])] for s in range(shards)]


def _even_planes(dim_z, shards):
    base, extra = divmod(dim_z, shards)
    return [base + (1 if s < extra else 0) for s in range(shards)]


# -- the stub-world cases (tests/test_multihost.py), per package -------------

def _case_build_matches_global(pkg, num_processes, shards_per_process):
    mh, build, tt = PACKAGES[pkg]
    rng = np.random.default_rng(7)
    dims = (11, 12, 13)
    shards = num_processes * shards_per_process
    parts = _split(rng, dims, shards)
    planes = _even_planes(dims[2], shards)
    expect = build(tt.C2C, *dims, parts, planes)

    def one(p, collective):
        lo = p * shards_per_process
        hi = lo + shards_per_process
        return mh.build_distributed_plan_multihost(
            tt.C2C, *dims, parts[lo:hi], planes[lo:hi],
            collective=collective)

    return expect, StubWorld(num_processes).run(one)


def _case_empty_shard(pkg):
    mh, build, tt = PACKAGES[pkg]
    rng = np.random.default_rng(8)
    dims = (8, 9, 10)
    parts = _split(rng, dims, 1) + [np.zeros((0, 3), np.int64)]
    planes = [6, 4]
    expect = build(tt.C2C, *dims, parts, planes)

    def one(p, collective):
        return mh.build_distributed_plan_multihost(
            tt.C2C, *dims, [parts[p]], [planes[p]], collective=collective)

    return expect, StubWorld(2).run(one)


def _case_unequal_shard_counts(pkg):
    mh, _, tt = PACKAGES[pkg]
    rng = np.random.default_rng(9)
    dims = (8, 9, 10)
    parts = _split(rng, dims, 3)

    def one(p, collective):
        mine = [parts[0], parts[1]] if p == 0 else [parts[2]]
        planes = [5, 5] if p == 0 else [10]
        return mh.build_distributed_plan_multihost(
            tt.C2C, *dims, mine, planes, collective=collective)

    return None, StubWorld(2).run(one)


def _case_mismatched_dims(pkg):
    mh, _, tt = PACKAGES[pkg]
    rng = np.random.default_rng(10)
    dims = (8, 9, 10)
    parts = _split(rng, dims, 2)

    def one(p, collective):
        my_dims = dims if p == 0 else (8, 9, 11)
        planes = 5 if p == 0 else 6
        return mh.build_distributed_plan_multihost(
            tt.C2C, *my_dims, [parts[p]], [planes], collective=collective)

    return None, StubWorld(2).run(one)


def _case_mismatched_r2c(pkg):
    """One process asks for R2C, the other C2C: the scalar round names
    the disagreement on every process."""
    mh, _, tt = PACKAGES[pkg]
    rng = np.random.default_rng(13)
    dims = (8, 9, 10)
    trip = random_sparse_triplets(rng, dims)
    parts = _split(rng, dims, 2, trip[trip[:, 0] <= dims[0] // 2])

    def one(p, collective):
        return mh.build_distributed_plan_multihost(
            tt.R2C if p else tt.C2C, *dims, [parts[p]], [5],
            collective=collective)

    return None, StubWorld(2).run(one)


def _case_validate_mismatch(pkg):
    mh, build, tt = PACKAGES[pkg]
    rng = np.random.default_rng(11)
    dims = (8, 9, 10)
    parts = _split(rng, dims, 2)
    plans = [build(tt.C2C, *dims, parts, [5, 5]),
             build(tt.C2C, *dims, parts, [6, 4])]

    def one(p, collective):
        return mh.validate_consistent(plans[p], collective=collective)

    return None, StubWorld(2).run(one)


def _case_validate_agreement(pkg):
    mh, build, tt = PACKAGES[pkg]
    rng = np.random.default_rng(12)
    dims = (8, 9, 10)
    parts = _split(rng, dims, 2)
    plan = build(tt.C2C, *dims, parts, [5, 5])

    def one(p, collective):
        mh.validate_consistent(plan, collective=collective)
        return True

    return None, StubWorld(3).run(one)


CASES = {
    "build_2x2": lambda pkg: _case_build_matches_global(pkg, 2, 2),
    "build_3x1": lambda pkg: _case_build_matches_global(pkg, 3, 1),
    "empty_shard": _case_empty_shard,
    "unequal_shard_counts": _case_unequal_shard_counts,
    "mismatched_dims": _case_mismatched_dims,
    "mismatched_transform": _case_mismatched_r2c,
    "validate_mismatch": _case_validate_mismatch,
    "validate_agreement": _case_validate_agreement,
}


def _outcome(status, value):
    """A comparable outcome: a plan's fingerprint, True, or the error's
    class name and message."""
    if status == "err":
        return ("err", type(value).__name__, str(value))
    if value is True or value is None:
        return ("ok", value)
    return ("plan", tmh.plan_fingerprint(value)
            if isinstance(value, tpar.DistributedIndexPlan)
            else jmh.plan_fingerprint(value))


@pytest.mark.parametrize("case", sorted(CASES))
def test_stub_world_case_matches_jax(case):
    """Every process ends as the JAX package's does: the same plan (by
    digest, equal to the single-process build's) or the same error class
    and message."""
    want_plan, want = CASES[case]("jax")
    got_plan, got = CASES[case]("port")
    assert [_outcome(*r) for r in got] == [_outcome(*r) for r in want]
    if want_plan is not None:
        for status, plan in got:
            assert status == "ok", plan
            assert tmh.plan_fingerprint(plan) == \
                tmh.plan_fingerprint(got_plan)
    for status, err in got:
        if status == "err":
            assert isinstance(err, sp.ParameterMismatchError)
    if case == "validate_mismatch":
        for p, (_, err) in enumerate(got):
            assert f"[{1 - p}]" in str(err)
    if case == "unequal_shard_counts":
        assert all("shards_per_process differs" in str(e) for _, e in got)


# -- the single-process cases ------------------------------------------------

def test_single_process_build_matches_local():
    rng = np.random.default_rng(3)
    dims = (11, 12, 13)
    parts = _split(rng, dims, 4)
    planes = [4, 3, 3, 3]
    a = tpar.build_distributed_plan(sp.TransformType.C2C, *dims, parts,
                                    planes)
    b = sp.build_distributed_plan_multihost(sp.TransformType.C2C, *dims,
                                            parts, planes)
    assert sp.plan_fingerprint(a) == sp.plan_fingerprint(b)
    sp.validate_consistent(b)  # one process: a no-op


def test_fingerprint_sensitivity():
    rng = np.random.default_rng(4)
    dims = (11, 12, 13)
    parts = _split(rng, dims, 2)
    build = tpar.build_distributed_plan
    a = build(sp.TransformType.C2C, *dims, parts, [7, 6])
    assert sp.plan_fingerprint(a) != sp.plan_fingerprint(
        build(sp.TransformType.C2C, *dims, parts, [6, 7]))
    assert sp.plan_fingerprint(a) != sp.plan_fingerprint(
        build(sp.TransformType.C2C, *dims, [parts[1], parts[0]], [7, 6]))
    assert sp.plan_fingerprint(a) == sp.plan_fingerprint(
        build(sp.TransformType.C2C, *dims, parts, [7, 6]))


@pytest.mark.parametrize("transform", ["c2c", "r2c"])
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("split", ["even", "uneven", "empty"])
def test_fingerprint_is_the_jax_digest(transform, centered, split):
    """The same 16 bytes as the JAX package's digest of the same plan."""
    rng = np.random.default_rng([len(transform), int(centered), len(split)])
    dims = (11, 10, 9)
    trip = random_sparse_triplets(rng, dims)
    if transform == "r2c":
        trip = trip[trip[:, 0] <= dims[0] // 2]
    if centered:
        c = center_triplets(trip, dims)
        if transform == "r2c":
            c[:, 0] = trip[:, 0]
        trip = c
    parts = _split(rng, dims, 3, trip)
    planes = {"even": [3, 3, 3], "uneven": [5, 1, 3],
              "empty": [0, 9, 0]}[split]
    if split == "empty":
        parts = [np.zeros((0, 3), np.int64), trip, parts[0][:0]]
    jp = jpar.build_distributed_plan(spfft_tpu.TransformType(transform),
                                     *dims, parts, planes)
    tp = tpar.build_distributed_plan(sp.TransformType(transform), *dims,
                                     parts, planes)
    assert sp.plan_fingerprint(tp) == jmh.plan_fingerprint(jp)
    assert len(sp.plan_fingerprint(tp)) == 16


def test_digest_mismatch_detection():
    local = bytes(range(16))
    same = np.tile(np.frombuffer(local, np.uint8), (3, 1))
    tmh._check_digests(same, local)
    bad = same.copy()
    bad[1, 0] ^= 0xFF
    with pytest.raises(sp.ParameterMismatchError, match=r"\[1\]"):
        tmh._check_digests(bad, local)


def test_pad_gather_roundtrip_matches_jax():
    t0 = np.array([[0, 0, 0], [1, 2, 3]])
    t1 = np.zeros((0, 3), np.int64)
    block = tmh._pad_gather_triplets([t0, t1], 5)
    np.testing.assert_array_equal(block,
                                  jmh._pad_gather_triplets([t0, t1], 5))
    assert block.shape == (2, 5, 4)
    np.testing.assert_array_equal(block[0][block[0, :, 3] == 1][:, :3], t0)
    assert (block[1, :, 3] == 0).all()


def test_shards_per_process_refusals():
    rng = np.random.default_rng(5)
    dims = (8, 8, 8)
    parts = _split(rng, dims, 2)
    with pytest.raises(sp.ParameterMismatchError):
        sp.build_distributed_plan_multihost(sp.TransformType.C2C, *dims,
                                            parts, [4, 4],
                                            shards_per_process=3)
    for kw in ({"shards_per_process": 0}, {}):
        with pytest.raises(sp.ParameterMismatchError, match=">= 1"):
            sp.build_distributed_plan_multihost(
                sp.TransformType.C2C, 8, 8, 8, [], [], **kw)


def test_initialize_without_an_address_is_a_no_op():
    import torch.distributed as dist
    sp.initialize_multihost()
    assert not dist.is_initialized()
    assert tpar.initialize_multihost is tmh.initialize


def test_mesh_over_a_group_refusals():
    """A group mesh needs an initialized group; several devices without
    one are several processes; S must divide over the ranks."""
    with pytest.raises(sp.DistributedError, match="not initialized"):
        sp.make_mesh(4, "cpu", process_group=object())
    with pytest.raises(sp.InvalidParameterError, match="process_group"):
        sp.make_mesh(2, ["cpu", "cuda:1"])


def test_planner_and_multihost_never_import_jax():
    """The port's planner and multi-process modules (and the ranks' test
    worker) leave JAX and the JAX package out of sys.modules."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["spfft_tpu_torch.native.planner",
            "spfft_tpu_torch.parallel.multihost", "torch_ranks_worker"]
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {os.path.join(repo, 'tests')!r})\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'spfft_tpu' or "
            "m.startswith('spfft_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=repo)
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
