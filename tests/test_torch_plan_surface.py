"""The local plan surface the serving layer calls, and the fault seams,
records and knobs wired into the plans, against the JAX package's plans
on the CPU.

* The runtime demotion ladder: the scenarios of
  tests/test_fused_kernel.py (a ``kernel.launch`` fault demotes one
  direction, the re-probe readmits, failed probes make it permanent, the
  forward direction is independent, a request-shaped error demotes
  nothing) run through both plans with the same ``FaultPlan`` scripts:
  the same ``fused_demotions()``, outcomes and counters after every call,
  and the same checks of each site (the trace-time seam fires on the
  first call of each executable the JAX package compiles). The JAX plans
  run their fused kernels in interpret mode (the CPU fused lane of
  tests/test_fused_kernel.py); a demoted port plan's results are bit for
  bit those of a ``fused=False`` plan.
* ``plan.build`` (the constructor's check raises, the table build's is
  a sticky ``TableBuildError``), the distributed plan's
  ``exchange.quantize`` decline and ``exchange.*`` seams, its records and
  its knobs from ``global_config()``.
* ``export_tables`` / ``restore_plan`` bit for bit, ``install_aot``,
  ``max_rel_error``, ``donate_inputs``, ``device=`` and
  ``estimated_device_bytes``.

Tolerance against the JAX package: 2e-6 relative l2 (float32)."""

import functools
import gc
import weakref

import numpy as np
import pytest
import torch

import spfft_tpu
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu import parallel as jpar
from spfft_tpu.control import config as jcfg

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch import plan as tplan
from spfft_tpu_torch.control import config as tcfg

from test_distributed import split_by_sticks, split_planes
from test_util import hermitian_triplets, random_sparse_triplets

torch.set_num_threads(2)

TOL = 2e-6
DIM_Z = 128  # the JAX package's smallest fused-eligible z
AFTER = tplan.TransformPlan.FUSED_REPROBE_AFTER


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for f, o, c in ((faults, obs, tcfg), (jfaults, jobs, jcfg)):
            f.disarm()
            o.GLOBAL_COUNTERS.reset()
            o.reset_recorder()
            c.set_global_config(None)
    reset()
    yield
    reset()


@pytest.fixture
def fused_env(monkeypatch):
    """The JAX package's CPU fused lane: the matmul-DFT pipeline forced on
    and the fused kernels in interpret mode."""
    monkeypatch.setenv("SPFFT_TPU_FORCE_MATMUL_DFT", "1")
    monkeypatch.setenv("SPFFT_TPU_FUSED_INTERPRET", "1")


def _gappy(nx=8, ny=6, nz=DIM_Z):
    return np.array([(x, y, z) for x in range(nx) for y in range(ny)
                     if (x + y) % 3 != 0 for z in range(0, nz, 2)], np.int32)


def _pair_plans(trip=None, dims=(8, 6, DIM_Z), **kw):
    trip = _gappy(*dims) if trip is None else trip
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType.C2C, *dims, trip,
                                   precision="single", use_pallas=True)
    tp = sp.make_local_plan(sp.TransformType.C2C, *dims, trip, device="cpu",
                            **kw)
    return jp, tp


def _values(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


LADDER_SERIES = (("spfft_fused_demotions_total", ("which",)),
                 ("spfft_fused_reprobes_total", ("which", "outcome")),
                 ("spfft_faults_injected_total", ("site", "kind")))


def _series(o):
    snap = o.GLOBAL_COUNTERS.snapshot()
    return {name: snap.get(name, {}).get("samples", {})
            for name, _ in LADDER_SERIES}


def _step(mod, plan, call, vals, space):
    """One public call; its outcome (the error's type name or "ok")."""
    kind = call[0]
    try:
        if kind == "b":
            plan.backward(vals)
        elif kind == "f":
            plan.forward(space, mod.Scaling(call[1]))
        elif kind == "bb":
            plan.backward_batched([vals] * call[1])
        elif kind == "fb":
            plan.forward_batched([space] * call[2], mod.Scaling(call[1]))
        elif kind == "ap":
            plan.apply_pointwise(vals)
        elif kind == "it":
            plan.iterate_pointwise(vals, None, steps=2)
        elif kind == "bad":
            plan.backward(np.zeros(3, np.complex64))
        return "ok"
    except Exception as exc:
        return type(exc).__name__


def _ladder(script, calls, fused_env_plans):
    """Run ``calls`` through both plans with ``script`` armed in each
    package; after every call the outcome, ``fused_demotions()`` and the
    ladder's counters must agree. Returns the port plan and the armed
    plans' stats."""
    jp, tp = fused_env_plans
    vals = _values(tp.index_plan.num_values)
    jspace = np.asarray(jp.backward(vals))
    tspace = tp.backward(vals)
    stats = []
    for f, mod, plan, space in ((jfaults, spfft_tpu, jp, jspace),
                                (faults, sp, tp, tspace)):
        fp = f.FaultPlan(script=script)
        f.arm(fp)
        trail = []
        try:
            for call in calls:
                out = _step(mod, plan, call, vals, space)
                trail.append((call, out, plan.fused_demotions()))
        finally:
            f.disarm()
        stats.append((trail, fp.stats()))
    (jtrail, jstats), (ttrail, tstats) = stats
    for (call, jout, jdem), (_, tout, tdem) in zip(jtrail, ttrail):
        assert (call, tout, tdem) == (call, jout, jdem)
    assert tstats == jstats
    assert _series(obs) == _series(jobs)
    return tp, tstats


CALLS = [("b",), ("b",), ("f", "none"), ("f", "full"), ("f", "none"),
         ("bb", 2), ("bb", 2), ("fb", "none", 2), ("bb", 3), ("b",),
         ("f", "full")]


@pytest.mark.parametrize("script", [
    "kernel.launch@999", "kernel.launch@1", "kernel.launch@2",
    "kernel.launch@4:permanent", "kernel.launch@2:poison"])
def test_scripts_fire_at_the_same_calls(fused_env, script):
    """The per-call seam and the trace-time seam fire at the same public
    calls in both packages: the same demotions, outcomes and counters
    after every call of a sequence over every entry."""
    tp, stats = _ladder(script, CALLS, _pair_plans())
    assert stats["checks"]["kernel.launch"] >= 3


def test_round_trips_consult_the_trace_time_seam_only(fused_env):
    """``apply_pointwise`` / ``iterate_pointwise`` reach each fused kernel
    once per executable (no per-call check), as the JAX package's round
    trips do."""
    calls = [("ap",), ("ap",), ("it",), ("it",), ("b",), ("ap",)]
    _, stats = _ladder("kernel.launch@999", calls, _pair_plans())
    # each round trip's two executables once; the backward's per-call
    # check (its executable ran before the script was armed)
    assert stats["checks"]["kernel.launch"] == 2 + 2 + 1


def _launch_checks(call):
    """How many times ``call()`` consults the ``kernel.launch`` seam."""
    fp = faults.FaultPlan(script="kernel.launch@999")
    faults.arm(fp)
    try:
        call()
    finally:
        faults.disarm()
    return fp.stats()["checks"].get("kernel.launch", 0)


def _same(space):
    return space


def test_round_trips_hold_their_callable_weakly():
    """A round trip's ``fn`` keys its executables' trace-time seams: the
    same callable consults them once, a fresh one afresh (a fresh
    callable recompiles in the JAX package), and a dropped one leaves the
    plan's record of seams, which keeps none of them alive."""
    plan = sp.make_local_plan(sp.TransformType.C2C, 8, 6, DIM_Z, _gappy(),
                              device="cpu")
    assert plan.fused_active
    vals = _values(plan.index_plan.num_values)
    ap = functools.partial(plan.apply_pointwise, vals)
    assert _launch_checks(functools.partial(ap, _same)) == 2
    assert _launch_checks(functools.partial(ap, _same)) == 0
    base = len(plan._seam_keys)
    refs = []
    for _ in range(4):
        fn = lambda s: s * 1.0  # noqa: E731 - a fresh callable each time
        refs.append(weakref.ref(fn))
        assert _launch_checks(functools.partial(ap, fn)) == 2
        assert _launch_checks(functools.partial(
            plan.iterate_pointwise, vals, fn, steps=2)) == 2
        del fn
    gc.collect()
    assert all(r() is None for r in refs)
    assert len(plan._seam_keys) == base
    assert _launch_checks(functools.partial(ap, _same)) == 0


def test_one_shard_plan_keeps_its_callable_stable():
    """A one-shard distributed plan runs its local delegate with one
    wrapper per ``fn`` (as the JAX package's), so the delegate's seams
    fire on the first call of an ``fn`` only, and a dropped ``fn`` takes
    its wrapper with it."""
    trip = _gappy()
    tp = sp.make_distributed_plan(sp.TransformType.C2C, 8, 6, DIM_Z,
                                  [trip], split_planes(DIM_Z, [1]),
                                  device="cpu")
    assert tp._local1 is not None and tp._local1.fused_active
    vals = [_values(len(trip))]
    ap = functools.partial(tp.apply_pointwise, vals)
    assert _launch_checks(functools.partial(ap, _same)) == 2
    assert _launch_checks(functools.partial(ap, _same)) == 0
    fn = lambda s: s  # noqa: E731
    ref = weakref.ref(fn)
    assert _launch_checks(functools.partial(ap, fn)) == 2
    assert _launch_checks(functools.partial(ap, fn)) == 0
    base = len(tp._local1._seam_keys)
    del fn
    gc.collect()
    assert ref() is None
    assert len(tp._local1._seam_keys) == base - 2
    assert len(tp._local1_fns) == 1


def test_launch_fault_demotes_one_direction(fused_env):
    jp, tp = _pair_plans()
    ref = sp.make_local_plan(sp.TransformType.C2C, 8, 6, DIM_Z, _gappy(),
                             device="cpu", fused=False)
    vals = _values(tp.index_plan.num_values)
    want = ref.backward(vals)
    calls = [("b",), ("b",), ("f", "none")]
    _ladder("kernel.launch@1", calls, (jp, tp))
    dem = tp.fused_demotions()
    assert set(dem) == {"dec"} and not dem["dec"]["permanent"]
    assert "InjectedFault" in dem["dec"]["reason"]
    assert dem["dec"]["unfused_ok"] == 1
    assert torch.equal(tp.backward(vals), want)  # the two-kernel route
    assert _rel(tp.backward(vals).numpy(), np.asarray(jp.backward(vals))) \
        <= TOL
    assert tp.fused_fallback_reasons["dec"] == dem["dec"]["reason"]
    assert [e["kind"] for e in obs.GLOBAL_JOURNAL.snapshot()
            if e["kind"].startswith("fused")] == ["fused.demote"]


def test_reprobe_readmits(fused_env):
    calls = [("b",)] * (AFTER + 2)
    tp, _ = _ladder("kernel.launch@1", calls, _pair_plans())
    assert tp.fused_demotions() == {}
    assert obs.GLOBAL_COUNTERS.get("spfft_fused_reprobes_total",
                                   which="dec", outcome="readmitted") == 1
    assert tp.fused_active and tp.fused_fallback_reasons == {}


def test_permanent_after_failed_probes(fused_env):
    calls = [("b",)] * (1 + tplan.TransformPlan.FUSED_REPROBE_MAX
                        * (AFTER + 1) + AFTER + 2)
    tp, _ = _ladder("kernel.launch@*", calls, _pair_plans())
    rec = tp.fused_demotions()["dec"]
    assert rec["permanent"] and not rec["probing"]
    assert rec["probes"] == tplan.TransformPlan.FUSED_REPROBE_MAX
    assert obs.GLOBAL_COUNTERS.get("spfft_fused_demotions_total",
                                   which="dec") == 4


def test_forward_direction_independent(fused_env):
    jp, tp = _pair_plans()
    ref = sp.make_local_plan(sp.TransformType.C2C, 8, 6, DIM_Z, _gappy(),
                             device="cpu", fused=False)
    _ladder("kernel.launch@1", [("f", "none"), ("b",), ("f", "full")],
            (jp, tp))
    assert set(tp.fused_demotions()) == {"cmp"}
    vals = _values(tp.index_plan.num_values)
    space = tp.backward(vals)
    for sc in (sp.Scaling.NONE, sp.Scaling.FULL):
        assert torch.equal(tp.forward(space, sc), ref.forward(space, sc))


def test_request_shaped_error_does_not_demote(fused_env):
    tp, _ = _ladder("kernel.launch@999", [("bad",), ("b",)], _pair_plans())
    assert tp.fused_demotions() == {}


def test_plan_build_seam_matches_jax(fused_env):
    trip = _gappy()
    for f in (faults, jfaults):
        f.arm(f.FaultPlan(script="plan.build@1"))
    try:
        with pytest.raises(jfaults.InjectedFault):
            spfft_tpu.make_local_plan(spfft_tpu.TransformType.C2C, 8, 6,
                                      DIM_Z, trip, use_pallas=True)
        with pytest.raises(faults.InjectedFault):
            sp.make_local_plan(sp.TransformType.C2C, 8, 6, DIM_Z, trip,
                               device="cpu")
    finally:
        faults.disarm()
        jfaults.disarm()
    for f in (faults, jfaults):
        f.arm(f.FaultPlan(script="plan.build@2"))
    try:
        jp, tp = _pair_plans(trip)
    finally:
        faults.disarm()
        jfaults.disarm()
    vals = _values(tp.index_plan.num_values)
    for plan, err in ((jp, spfft_tpu.errors.TableBuildError),
                      (tp, sp.errors.TableBuildError)):
        for _ in range(2):  # sticky
            with pytest.raises(err):
                plan.backward(vals)
        with pytest.raises(err):
            plan.check_build(wait=True)
        with pytest.raises(err):
            plan.export_tables()
        plan.close()  # never raises
    assert obs.GLOBAL_COUNTERS.get("spfft_plan_builds_total",
                                   kind="local") == 1


# -- the plan artifact ---------------------------------------------------------

def _surface_case(name):
    rng = np.random.default_rng(17)
    if name == "c2c":
        dims = (12, 13, 11)
        return "C2C", dims, random_sparse_triplets(rng, dims), {}
    if name == "c2c_two_kernel":
        dims = (12, 13, 11)
        return "C2C", dims, random_sparse_triplets(rng, dims), \
            {"fused": False}
    if name == "r2c_folded":
        dims = (12, 10, 9)
        t = hermitian_triplets(rng, dims).astype(np.int64)
        return "R2C", dims, t, {}
    if name == "r2c_conj":  # x < 0 stored as the conjugate at -x
        g = np.arange(-3, 4)
        t = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        t = t[(t ** 2).sum(1) <= 9]
        t = t[(t[:, 0] < 0) | ((t[:, 0] == 0) & (
            (t[:, 1] > 0) | ((t[:, 1] == 0) & (t[:, 2] >= 0))))]
        return "R2C", (8, 8, 8), t, {}
    if name == "split_x":
        g = np.arange(-2, 3)
        t = np.stack(np.meshgrid(g, g, np.arange(-7, 9), indexing="ij"),
                     -1).reshape(-1, 3)
        return "C2C", (24, 20, 16), t, {}
    if name == "double_prime_z":
        dims = (8, 9, 13)
        return "C2C", dims, random_sparse_triplets(rng, dims), \
            {"precision": "double"}
    raise KeyError(name)


SURFACE = ("c2c", "c2c_two_kernel", "r2c_folded", "r2c_conj", "split_x",
           "double_prime_z")


def _io(plan, seed=1):
    p = plan.index_plan
    rng = np.random.default_rng(seed)
    dt = np.float64 if plan.precision == "double" else np.float32
    if p.hermitian:
        space = rng.standard_normal((p.dim_z, p.dim_y, p.dim_x)).astype(dt)
        return plan.forward(space), space
    vals = rng.standard_normal((p.num_values, 2)).astype(dt)
    return vals, None


@pytest.mark.parametrize("name", SURFACE)
def test_export_restore_bit_for_bit(name):
    tt, dims, trip, kw = _surface_case(name)
    plan = sp.make_local_plan(sp.TransformType[tt], *dims, trip,
                              device="cpu", **kw)
    tables = plan.export_tables()
    assert isinstance(tables, sp.PlanTables)
    assert all(isinstance(a, np.ndarray) for a in tables.arrays.values())
    assert tables.fused == plan.fused_active
    builds = obs.GLOBAL_COUNTERS.get("spfft_plan_builds_total", kind="local")
    back = sp.restore_plan(plan.index_plan, tables,
                           precision=plan.precision, device="cpu",
                           **{k: v for k, v in kw.items()
                              if k != "precision"})
    assert obs.GLOBAL_COUNTERS.get("spfft_plan_builds_total",
                                   kind="local") == builds + 1
    assert back.split_x == plan.split_x
    assert (plan.split_x is not None) == (name == "split_x")
    vals, _ = _io(plan)
    a, b = plan.backward(vals), back.backward(vals)
    assert torch.equal(a, b)
    for sc in (sp.Scaling.NONE, sp.Scaling.FULL):
        assert torch.equal(plan.forward(a, sc), back.forward(a, sc))
    assert torch.equal(plan.apply_pointwise(vals), back.apply_pointwise(vals))
    for k, v in back.export_tables().arrays.items():
        np.testing.assert_array_equal(v, tables.arrays[k])
    if plan.fused_active:
        with pytest.raises(sp.InvalidParameterError):
            sp.restore_plan(plan.index_plan, tables, device="cpu",
                            fused=False, precision=plan.precision)
    cut = dict(tables.arrays, slot_src=tables.arrays["slot_src"][:-1])
    with pytest.raises(sp.InvalidParameterError, match="slot_src"):
        sp.restore_plan(plan.index_plan, sp.PlanTables(
            cut, tables.split_x, tables.grid_w, tables.fused,
            tables.fused_reasons), device="cpu", precision=plan.precision)


#: corruption -> (surface case, the table or field the refusal names)
CORRUPT = {
    "csr_val_past_end": ("c2c", "csr_val"),
    "csr_val_negative": ("c2c", "csr_val"),
    "csr_z_past_dim_z": ("c2c", "csr_z"),
    "csr_ptr_falls": ("c2c", "csr_ptr"),
    "csr_ptr_short_end": ("c2c", "csr_ptr"),
    "slot_src_past_sentinel": ("c2c", "slot_src"),
    "slot_src_wraps_int32": ("c2c", "slot_src"),
    "scatter_cols_past_grid": ("c2c", "scatter_cols"),
    "col_inv_past_sentinel": ("c2c", "col_inv"),
    "float_table": ("c2c", "csr_val"),
    "grid_w_off": ("c2c", "grid_w"),
    "split_x_past_grid": ("split_x", "split_x"),
    "value_indices_past_sticks": ("c2c_two_kernel", "value_indices"),
    "conj_sign_zero": ("r2c_conj", "conj_sign"),
    "conj_sign_two": ("r2c_conj", "conj_sign"),
}


def _corrupt(name, t, p):
    """``t`` with the corruption ``name`` for the index plan ``p``."""
    a = {k: v.copy() for k, v in t.arrays.items()}
    split, width = t.split_x, t.grid_w
    nv, ns, nz = p.num_values, p.num_sticks, p.dim_z
    if name == "csr_val_past_end":
        a["csr_val"][0] = nv
    elif name == "csr_val_negative":
        a["csr_val"][-1] = -1
    elif name == "csr_z_past_dim_z":
        a["csr_z"][0] = nz
    elif name == "csr_ptr_falls":
        a["csr_ptr"][1] = nv
    elif name == "csr_ptr_short_end":
        a["csr_ptr"][-1] = nv - 1
    elif name == "slot_src_past_sentinel":
        a["slot_src"][0] = nv + 1
    elif name == "slot_src_wraps_int32":
        a["slot_src"] = a["slot_src"].astype(np.int64)
        a["slot_src"][0] += 2 ** 32  # int32 would read the same slot
    elif name == "scatter_cols_past_grid":
        a["scatter_cols"][0] = width * p.dim_y
    elif name == "col_inv_past_sentinel":
        a["col_inv"][0] = ns + 1
    elif name == "float_table":
        a["csr_val"] = a["csr_val"].astype(np.float64)
    elif name == "grid_w_off":
        width += 1
    elif name == "split_x_past_grid":
        split = (split[0], split[1] + 1)
    elif name == "value_indices_past_sticks":
        a["value_indices"][0] = ns * nz
    elif name == "conj_sign_zero":
        a["conj_sign"][0] = 0
    elif name == "conj_sign_two":
        a["conj_sign"][0] = 2
    return sp.PlanTables(a, split, width, t.fused, t.fused_reasons)


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_restore_refuses_corrupt_tables(name):
    """A restored table whose shape fits but whose values would reach
    outside the tensors the kernels read and write (which check no
    index) is refused before anything reaches the device."""
    case, field = CORRUPT[name]
    tt, dims, trip, kw = _surface_case(case)
    plan = sp.make_local_plan(sp.TransformType[tt], *dims, trip,
                              device="cpu", **kw)
    tables = plan.export_tables()
    assert field in tables.arrays or field in ("grid_w", "split_x")
    bad = _corrupt(name, tables, plan.index_plan)
    with pytest.raises(sp.InvalidParameterError, match=field):
        sp.restore_plan(plan.index_plan, bad, device="cpu", **kw)


def test_install_aot_and_teardown():
    tt, dims, trip, kw = _surface_case("c2c")
    plan = sp.make_local_plan(sp.TransformType[tt], *dims, trip,
                              device="cpu")
    plan.install_aot(None)
    plan.install_aot({})
    with pytest.raises(sp.InvalidParameterError, match="no serialised"):
        plan.install_aot({"backward": b"x"})
    plan.check_build()
    plan.check_build(wait=True)
    plan.close()
    plan.close()
    vals, _ = _io(plan)
    plan.backward(vals)  # a closed plan still runs


@pytest.mark.parametrize("precision,ok,bad", [("single", 1e-3, 1e-9),
                                              ("double", 1e-12, 1e-16)])
def test_max_rel_error_contract_matches_jax(precision, ok, bad):
    trip = np.array([[x, y, z] for x in range(4) for y in range(4)
                     for z in range(4)], np.int32)
    for bound, raises in ((ok, False), (bad, True)):
        for mod, make in (
                (spfft_tpu, lambda: spfft_tpu.make_local_plan(
                    spfft_tpu.TransformType.C2C, 4, 4, 4, trip,
                    precision=precision, max_rel_error=bound)),
                (sp, lambda: sp.make_local_plan(
                    sp.TransformType.C2C, 4, 4, 4, trip, device="cpu",
                    precision=precision, max_rel_error=bound))):
            if raises:
                with pytest.raises(mod.PrecisionContractError,
                                   match="max_rel_error"):
                    make()
            else:
                assert make().precision == precision
    plan = sp.make_local_plan(sp.TransformType.C2C, 4, 4, 4, trip,
                              device="cpu", precision=precision)
    assert plan.predicted_error < ok
    with pytest.raises(sp.PrecisionContractError):
        sp.TransformPlan(plan.index_plan, precision=precision,
                         device="cpu", max_rel_error=bad)


@pytest.mark.parametrize("name", ["c2c", "r2c_folded"])
def test_donate_inputs_writes_into_the_values(name):
    tt, dims, trip, kw = _surface_case(name)
    keep = sp.make_local_plan(sp.TransformType[tt], *dims, trip,
                              device="cpu")
    give = sp.make_local_plan(sp.TransformType[tt], *dims, trip,
                              device="cpu", donate_inputs=True)
    vals, _ = _io(keep)
    vals = np.asarray(vals)
    fn = (lambda s, k: s * k)
    t = torch.from_numpy(vals.copy())
    got = give.iterate_pointwise(t, fn, 0.5, steps=3)
    assert got.data_ptr() == t.data_ptr()
    assert torch.equal(got, keep.iterate_pointwise(vals, fn, 0.5, steps=3))
    t2 = torch.from_numpy(vals.copy())
    got = give.apply_pointwise(t2, fn, 2.0, scaling=sp.Scaling.FULL)
    assert got.data_ptr() == t2.data_ptr()
    assert torch.equal(got, keep.apply_pointwise(vals, fn, 2.0,
                                                 scaling=sp.Scaling.FULL))
    # a tensor of another type is converted: the caller's is untouched
    t64 = torch.from_numpy(vals.astype(np.float64))
    before = t64.clone()
    give.apply_pointwise(t64)
    assert torch.equal(t64, before)


@pytest.mark.parametrize("name", ["c2c", "r2c_folded", "double_prime_z"])
def test_device_argument_on_all_four_entries(name):
    tt, dims, trip, kw = _surface_case(name)
    plan = sp.make_local_plan(sp.TransformType[tt], *dims, trip,
                              device="cpu", **kw)
    vals, _ = _io(plan)
    space = plan.backward(vals)
    for dev in ("cpu", torch.device("cpu")):
        assert torch.equal(plan.backward(vals, device=dev), space)
        assert torch.equal(plan.forward(space, device=dev),
                           plan.forward(space))
        assert torch.equal(plan.backward_batched([vals, vals], device=dev),
                           plan.backward_batched([vals, vals]))
        assert torch.equal(
            plan.forward_batched([space], sp.Scaling.FULL, device=dev),
            plan.forward_batched([space], sp.Scaling.FULL))
    assert plan._device_tables == {}  # its own device: no copy
    for bad in ("cuda", "cuda:0", "meta"):
        with pytest.raises(sp.GenericError):
            plan.backward(vals, device=bad)


@pytest.mark.parametrize("name", SURFACE)
def test_estimated_device_bytes_counts_the_plans_tensors(name):
    tt, dims, trip, kw = _surface_case(name)
    plan = sp.make_local_plan(sp.TransformType[tt], *dims, trip,
                              device="cpu", **kw)
    tensors = {}
    for v in plan._tabs.values():
        for t in (v if isinstance(v, tuple) else (v,)):
            tensors[t.data_ptr()] = t
    for m in plan._mats.values():
        for t in (m.tensors if m is not None else ()):
            tensors[t.data_ptr()] = t
    want = sum(t.numel() * t.element_size() for t in tensors.values())
    assert plan.estimated_device_bytes() == want > 0
    assert plan.estimated_device_bytes() > plan.index_plan.num_values * 4


# -- the distributed plan: wire rungs, exchange seams, records, knobs ---------

def _dist_case():
    dims = (8, 8, 8)
    trip = random_sparse_triplets(np.random.default_rng(5), dims)
    return dims, split_by_sticks(trip, dims, [1, 1]), split_planes(8, [1, 1])


def _dist_pair(**kw):
    dims, parts, planes = _dist_case()
    jp = jpar.make_distributed_plan(
        spfft_tpu.TransformType.C2C, *dims, parts, planes,
        mesh=jpar.make_mesh(len(parts)), precision="single",
        exchange=spfft_tpu.ExchangeType(kw.get("exchange", "default")),
        **{k: v for k, v in kw.items() if k != "exchange"})
    tp = sp.make_distributed_plan(
        sp.TransformType.C2C, *dims, parts, planes, device="cpu",
        exchange=sp.ExchangeType(kw.get("exchange", "default")),
        **{k: v for k, v in kw.items() if k != "exchange"})
    return jp, tp, parts


def _events(o, kinds):
    return [(e["kind"], e["attrs"]) for e in o.GLOBAL_JOURNAL.snapshot()
            if e["kind"] in kinds]


@pytest.mark.parametrize("script,budget", [
    ("exchange.quantize@1", 0.01), ("exchange.quantize@*", 1.0),
    ("exchange.quantize@2", 0.01), (None, 1e-9)])
def test_wire_decline_under_quantize_fault_matches_jax(script, budget):
    for f in (faults, jfaults):
        if script:
            f.arm(f.FaultPlan(script=script))
    try:
        jp, tp, _ = _dist_pair(exchange="buffered", wire_precision=3,
                               wire_error_budget=budget)
    finally:
        faults.disarm()
        jfaults.disarm()
    assert tp.wire_rung_name == jp.wire_rung_name
    assert tp.wire_declines == jp.wire_declines
    assert tp.wire_probe_error == jp.wire_probe_error
    if script in ("exchange.quantize@1", "exchange.quantize@*"):
        assert tp.wire_declines[0] == ("int8", "fault_injected")
    kinds = ("wire.decline", "wire.resolve")
    assert _events(obs, kinds) == _events(jobs, kinds)
    assert obs.GLOBAL_COUNTERS.snapshot().get(
        "spfft_wire_rung_declined_total") == jobs.GLOBAL_COUNTERS.snapshot(
        ).get("spfft_wire_rung_declined_total")


@pytest.mark.parametrize("script,k", [
    ("exchange.collective@1", 1), ("exchange.pack@2,exchange.unpack@2", 1),
    ("exchange.unpack@1", 1), ("exchange.chunk@3", 2),
    ("exchange.pack@4,exchange.chunk@1", 2), ("exchange.pack@999", 2)])
def test_exchange_seams_fire_at_the_same_calls(script, k):
    jp, tp, parts = _dist_pair(overlap_chunks=k)
    vals = [_values(len(p), i) for i, p in enumerate(parts)]
    space = np.asarray(jp.backward(vals))
    tp.backward(vals)  # each plan's backward ran once before the script
    outs = []
    for f, mod, plan in ((jfaults, spfft_tpu, jp), (faults, sp, tp)):
        fp = f.FaultPlan(script=script)
        f.arm(fp)
        trail = []
        try:
            for call in ("b", "f", "b", "f", "ap", "b"):
                try:
                    if call == "b":
                        plan.backward(vals)
                    elif call == "f":
                        plan.forward(space if mod is spfft_tpu
                                     else torch.from_numpy(space))
                    else:
                        plan.apply_pointwise(vals)
                    trail.append("ok")
                except f.InjectedFault as exc:
                    trail.append(str(exc))
        finally:
            f.disarm()
        outs.append((trail, fp.stats()))
    assert outs[1] == outs[0]


def test_dist_records_and_knobs_match_jax():
    """Construction records and the knobs from ``global_config()``: both
    packages' plans take overlap_chunks 2 from the config, and count the
    same plan builds, exchange plans and wire bytes."""
    for c in (tcfg, jcfg):
        c.set_global_config(c.ServeConfig({"overlap_chunks": 2}))
    obs.enable()
    jobs.enable()
    jp, tp, _ = _dist_pair(exchange="buffered")
    assert tp.overlap_chunks == jp.overlap_chunks == 2
    assert tp.exchange_wire_bytes() == jp.exchange_wire_bytes()
    names = ("spfft_plan_builds_total", "spfft_exchange_plans_total",
             "spfft_exchange_wire_bytes", "spfft_exchange_busiest_link_bytes",
             "spfft_wire_rung")
    ts, js = obs.GLOBAL_COUNTERS.snapshot(), jobs.GLOBAL_COUNTERS.snapshot()
    for n in names:
        assert ts[n]["samples"] == js[n]["samples"], n
    span = next(e for e in obs.GLOBAL_TRACER.events()
                if getattr(e, "name", "") == "exchange.plan_build")
    jspan = next(e for e in jobs.GLOBAL_TRACER.events()
                 if getattr(e, "name", "") == "exchange.plan_build")
    assert span.args == jspan.args
    assert span.args["wire_bytes"] == tp.exchange_wire_bytes()
    assert len(span.args["per_chunk"]) == 2
