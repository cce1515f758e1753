"""The port's distributed plan over the ranks of a ``torch.distributed``
process group: 2 and 3 spawned gloo ranks on the CPU
(``tests/torch_ranks_worker.py``, one process each, with a timeout).

Each rank builds every case's plan from its OWN shards' triplets
(``build_distributed_plan_multihost``, the real collective) on a mesh
over the group, and runs backward, forward(FULL) of that and forward(NONE)
of given slabs on its own shards. Per case, the ranks' shards stacked:

* bit for bit the one-process plan's (the same S shards on one device, the
  same exchange, K and wire): every exchange kind over ranks
  (``all_to_all`` for ``BUFFERED``, ``p2p_ring``, ``all_to_all_v`` for the
  ragged schedule, ``p2p_ops`` for the op schedule, K = 2 chunks of each),
  every wire rung (f32, bf16, int8, the ``*_FLOAT`` exchanges), C2C and
  R2C, single and double, fused and two-kernel, uneven and empty shards;
  the same exchange kind name, wire rung, wire bytes and plan digest;
* within 2e-6 relative l2 (single; 1e-12 double) of the JAX package's
  ``DistributedTransformPlan`` (``use_pallas=False``) on the same inputs,
  the lossy rungs within ``max(4 * wire_probe_error,
  predicted_rel_error)`` of it, the bound chip_smoke.py holds.

A rank passing other dims raises ``ParameterMismatchError`` on every rank;
a backend that refuses a collective on the plan's device is refused at
construction with ``DistributedError``.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax

import spfft_tpu
from spfft_tpu import parallel as jpar

import spfft_tpu_torch as sp
from spfft_tpu_torch.parallel import dist as tdist
from spfft_tpu_torch.parallel import mesh as tmesh

from test_distributed import split_by_sticks, split_planes
from test_util import hermitian_triplets, random_sparse_triplets

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_ranks_worker.py")
#: seconds a world of ranks may take before the test fails
WORLD_TIMEOUT_S = 150
DIMS = (11, 12, 13)
#: the worlds: ranks -> shards (2 ranks hold 2 shards each, 3 ranks one)
WORLDS = {2: 4, 3: 3}
#: the input sets: stick weights and plane weights over S = 4 (the first
#: S entries at S = 3)
INPUTS = {"c2c": ("c2c", [3, 1, 2, 1], [1, 2, 1, 1]),
          "r2c": ("r2c", [1, 3, 2, 2], [2, 1, 3, 1]),
          "c2c_empty": ("c2c", [1, 0, 2, 0], [0, 2, 0, 1]),
          "r2c_empty": ("r2c", [0, 2, 1, 0], [1, 0, 2, 0])}
#: the cases: name -> (input set, precision, exchange, op schedule, K,
#: wire_precision, fused)
CASES = {
    "buffered": ("c2c", "single", "BUFFERED", False, 1, 0, True),
    "ring": ("c2c", "single", "UNBUFFERED", False, 1, 0, True),
    "ragged": ("c2c", "single", "COMPACT_BUFFERED", False, 1, 0, True),
    "compact": ("c2c", "single", "COMPACT_BUFFERED", True, 1, 0, True),
    "buffered_k2": ("c2c", "single", "BUFFERED", False, 2, 0, True),
    "ring_k2": ("c2c", "single", "UNBUFFERED", False, 2, 0, True),
    "ragged_k2": ("c2c", "single", "COMPACT_BUFFERED", False, 2, 0, True),
    "compact_k2": ("c2c", "single", "COMPACT_BUFFERED", True, 2, 0, True),
    "buffered_two_kernel": ("c2c", "single", "BUFFERED", False, 1, 0,
                            False),
    "ragged_two_kernel": ("c2c", "single", "COMPACT_BUFFERED", False, 1, 0,
                          False),
    "wire_f32": ("c2c", "single", "BUFFERED", False, 1, 1, True),
    "wire_bf16": ("c2c", "single", "BUFFERED", False, 1, 2, True),
    "wire_int8": ("c2c", "single", "BUFFERED", False, 1, 3, True),
    "wire_int8_k2": ("c2c", "single", "BUFFERED", False, 2, 3, True),
    "ring_int8": ("c2c", "single", "UNBUFFERED", False, 1, 3, True),
    "buffered_float": ("c2c", "single", "BUFFERED_FLOAT", False, 1, 0,
                       True),
    "compact_float": ("c2c", "single", "COMPACT_BUFFERED_FLOAT", False, 1,
                      0, True),
    "ragged_bf16_k2": ("c2c", "single", "COMPACT_BUFFERED", False, 2, 2,
                       True),
    "r2c_buffered": ("r2c", "single", "BUFFERED", False, 1, 0, True),
    "r2c_ragged": ("r2c", "single", "COMPACT_BUFFERED", False, 1, 0, True),
    "r2c_ring": ("r2c", "single", "UNBUFFERED", False, 1, 0, True),
    "r2c_compact_k2": ("r2c", "single", "COMPACT_BUFFERED", True, 2, 0,
                       True),
    "r2c_wire_int8": ("r2c", "single", "BUFFERED", False, 1, 3, True),
    "double_buffered": ("c2c", "double", "BUFFERED", False, 1, 0, True),
    "double_ragged": ("c2c", "double", "COMPACT_BUFFERED", False, 1, 0,
                      True),
    "double_wire_f32": ("c2c", "double", "BUFFERED", False, 1, 1, True),
    "double_r2c_ragged_k2": ("r2c", "double", "COMPACT_BUFFERED", False, 2,
                             0, True),
    "empty_buffered": ("c2c_empty", "single", "BUFFERED", False, 1, 0,
                       True),
    "empty_ragged": ("c2c_empty", "single", "COMPACT_BUFFERED", False, 1, 0,
                     True),
    "empty_compact": ("c2c_empty", "single", "COMPACT_BUFFERED", True, 1, 0,
                      True),
    "empty_r2c_ragged_k2": ("r2c_empty", "single", "COMPACT_BUFFERED", False,
                            2, 0, False),
}
#: the kind each mechanism takes over ranks
RANK_KIND = {"block": "all_to_all", "ring": "p2p_ring",
             "ragged": "all_to_all_v", "compact": "p2p_ops"}


def _inputs(name, shards):
    """Every shard's triplets and plane count, and its values (a seeded
    field's spectrum for R2C, random for C2C) at complex128."""
    kind, sticks, planes = INPUTS[name]
    rng = np.random.default_rng([len(name), shards])
    trip = (hermitian_triplets(rng, DIMS) if kind == "r2c"
            else random_sparse_triplets(rng, DIMS))
    parts = split_by_sticks(trip, DIMS, sticks[:shards])
    planes = split_planes(DIMS[2], planes[:shards])
    if kind == "r2c":
        spec = np.fft.fftn(rng.standard_normal(DIMS[::-1]))
        vals = [spec[p[:, 2], p[:, 1], p[:, 0]] for p in parts]
    else:
        vals = [rng.uniform(-1, 1, len(p)) + 1j * rng.uniform(-1, 1, len(p))
                for p in parts]
    return kind, parts, planes, vals


def _cdtype(precision):
    return np.complex64 if precision == "single" else np.complex128


@functools.lru_cache(maxsize=None)
def _jax_reference(name, shards, precision):
    """The JAX package's plan on the same inputs (BUFFERED,
    ``use_pallas=False``): its backward, forward(FULL) of it, and the
    per-shard slabs of that backward, the forward(NONE) input of every
    case."""
    kind, parts, planes, vals = _inputs(name, shards)
    vals = [v.astype(_cdtype(precision)) for v in vals]
    jp = jpar.make_distributed_plan(
        spfft_tpu.TransformType[kind.upper()], *DIMS, parts, planes,
        mesh=jpar.make_mesh(shards), precision=precision, use_pallas=False)
    jb = np.asarray(jp.backward(vals))
    put = jax.device_put(jb, jp._sharded)
    out = {"backward": jb,
           "forward_full": np.asarray(jp.forward(put, spfft_tpu.Scaling.FULL)),
           "forward_none": np.asarray(jp.forward(put,
                                                 spfft_tpu.Scaling.NONE))}
    slabs = [jb[r, :planes[r]] for r in range(shards)]
    if kind == "c2c":
        slabs = [s[..., 0] + 1j * s[..., 1] for s in slabs]
    return out, vals, slabs


def _case_npz(tmp, case, shards):
    inp, precision = CASES[case][:2]
    kind, parts, planes, _ = _inputs(inp, shards)
    _, vals, slabs = _jax_reference(inp, shards, precision)
    path = os.path.join(tmp, f"{inp}_{precision}.npz")
    if not os.path.exists(path):
        np.savez(path, num_shards=shards, planes=np.asarray(planes),
                 **{f"parts_{r}": parts[r] for r in range(shards)},
                 **{f"values_{r}": vals[r] for r in range(shards)},
                 **{f"space_{r}": slabs[r] for r in range(shards)})
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _world(ranks):
    """Run every case in a world of ``ranks`` gloo ranks on the CPU; each
    rank's outputs, by case."""
    shards = WORLDS[ranks]
    tmp = tempfile.mkdtemp(prefix=f"spfft_ranks{ranks}_")
    cases = []
    for name, (inp, prec, ex, pp, k, wire, fused) in CASES.items():
        cases.append({"name": name, "npz": _case_npz(tmp, name, shards),
                      "dims": DIMS, "transform": INPUTS[inp][0],
                      "precision": prec, "exchange": ex, "ppermute": pp,
                      "k": k, "wire": wire, "fused": fused})
    cases.append({"name": "mismatch", "npz": _case_npz(tmp, "buffered",
                                                       shards),
                  "dims": DIMS, "mismatch": True})
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"port": _free_port(), "world": ranks, "backend": "gloo",
                   "device": "cpu", "out": tmp, "cases": cases}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, spec, str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(ranks)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORLD_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * ranks, f"rank exit codes {rcs}:\n" + "\n".join(
        log[-3000:] for log in logs)
    return {c["name"]: [dict(np.load(os.path.join(tmp, f"{c['name']}_r{r}"
                                                  ".npz")))
                        for r in range(ranks)] for c in cases}


@functools.lru_cache(maxsize=None)
def _one_process(case, shards):
    """The same plan with its S shards in this process (``device="cpu"``):
    its plan and the three outputs."""
    inp, precision, ex, pp, k, wire, fused = CASES[case]
    kind, parts, planes, _ = _inputs(inp, shards)
    _, vals, slabs = _jax_reference(inp, shards, precision)
    old = os.environ.pop(tdist.COMPACT_PPERMUTE_ENV, None)
    if pp:
        os.environ[tdist.COMPACT_PPERMUTE_ENV] = "1"
    try:
        plan = sp.make_distributed_plan(
            sp.TransformType[kind.upper()], *DIMS, parts, planes,
            device="cpu", precision=precision, exchange=sp.ExchangeType[ex],
            overlap_chunks=k, wire_precision=wire, wire_error_budget=1.0,
            fused=fused)
    finally:
        os.environ.pop(tdist.COMPACT_PPERMUTE_ENV, None)
        if old is not None:
            os.environ[tdist.COMPACT_PPERMUTE_ENV] = old
    b = plan.backward(vals)
    return plan, {"backward": b.numpy(),
                  "forward_full": plan.forward(b, sp.Scaling.FULL).numpy(),
                  "forward_none": plan.forward(slabs,
                                               sp.Scaling.NONE).numpy()}


def _stacked(outs, key):
    return np.concatenate([o[key] for o in outs])


def _rel(got, want):
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


PARAMS = [(r, c) for r in sorted(WORLDS) for c in CASES]
IDS = [f"{r}ranks-{c}" for r, c in PARAMS]


@pytest.mark.parametrize("ranks,case", PARAMS, ids=IDS)
def test_ranks_equal_the_one_process_plan(ranks, case):
    """Backward, forward(FULL) and forward(NONE) over the ranks, stacked,
    bit for bit the one-process plan's; the rank kind, rung, wire bytes
    and digest alike; a second backward equal to the first."""
    outs = _world(ranks)[case]
    plan, want = _one_process(case, WORLDS[ranks])
    for key in ("backward", "forward_full", "forward_none"):
        got = _stacked(outs, key)
        assert got.dtype == want[key].dtype and got.shape == want[key].shape
        np.testing.assert_array_equal(got, want[key], err_msg=key)
    kind = plan.exchange_kind
    base, _, k = kind.partition("x")
    want_kind = RANK_KIND[base] + (f"x{k}" if k else "")
    for o in outs:
        assert str(o["kind"]) == want_kind
        assert str(o["rung"]) == plan.wire_rung_name
        assert int(o["wire_bytes"]) == plan.exchange_wire_bytes()
        assert bool(o["repeat_equal"])
        assert bytes(o["fingerprint"]) == sp.plan_fingerprint(plan.dist_plan)


@pytest.mark.parametrize("ranks,case", PARAMS, ids=IDS)
def test_ranks_match_the_jax_plan(ranks, case):
    """The ranks' outputs against the JAX package's plan on the same
    inputs: 2e-6 relative l2 in single, 1e-12 in double, a lossy rung
    within ``max(4 * wire_probe_error, predicted_rel_error)``."""
    inp, precision = CASES[case][:2]
    outs = _world(ranks)[case]
    want, _, _ = _jax_reference(inp, WORLDS[ranks], precision)
    tol = 2e-6 if precision == "single" else 1e-12
    if str(outs[0]["rung"]) != "full":
        tol = max(4 * float(outs[0]["probe"]),
                  sp.predicted_rel_error(precision, max(DIMS)))
    for key in ("backward", "forward_full", "forward_none"):
        assert _rel(_stacked(outs, key), want[key]) <= tol, key


@pytest.mark.parametrize("ranks", sorted(WORLDS))
def test_mismatched_dims_raise_on_every_rank(ranks):
    """Rank 1 passing another dim_z raises ParameterMismatchError on every
    rank, in the same collective round (no rank hangs)."""
    outs = _world(ranks)["mismatch"]
    assert [str(o["raised"]) for o in outs] == \
        ["ParameterMismatchError"] * ranks


class _Group:
    """A stand-in process group for the construction-time checks."""


@pytest.mark.parametrize("backend,device,exchange,ppermute,refused", [
    ("gloo", "cuda", "UNBUFFERED", False, "batch_isend_irecv"),
    ("gloo", "cuda", "COMPACT_BUFFERED", True, "batch_isend_irecv"),
    ("nccl", "cpu", "BUFFERED", False, "all_to_all_single"),
    ("nccl", "cpu", "COMPACT_BUFFERED", False, "all_to_all_single"),
])
def test_a_refused_collective_is_a_typed_error(monkeypatch, backend, device,
                                               exchange, ppermute, refused):
    """A backend that refuses the exchange's collective on the plan's
    device is refused at construction, naming the backend, the primitive
    and the exchange kind; nothing is moved to the host instead."""
    monkeypatch.setattr(tmesh.Mesh, "backend", property(lambda m: backend))
    if ppermute:
        monkeypatch.setenv(tdist.COMPACT_PPERMUTE_ENV, "1")
    else:
        monkeypatch.delenv(tdist.COMPACT_PPERMUTE_ENV, raising=False)
    kind, parts, planes, _ = _inputs("c2c", 4)
    dp = sp.parallel.build_distributed_plan(sp.TransformType.C2C, *DIMS,
                                            parts, planes)
    mesh = tmesh.Mesh(4, torch.device(device, 0) if device == "cuda"
                      else torch.device("cpu"), process_group=_Group(),
                      num_processes=2, rank=0)
    with pytest.raises(sp.DistributedError) as exc:
        sp.DistributedTransformPlan(dp, mesh=mesh,
                                    exchange=sp.ExchangeType[exchange])
    msg = str(exc.value)
    assert backend in msg and refused in msg
    assert any(k in msg for k in RANK_KIND.values())
