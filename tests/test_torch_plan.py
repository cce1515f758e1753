"""The port's local plan (``make_local_plan(..., device="cpu")``, every
kernel wrapper on its plain version) against
``spfft_tpu.make_local_plan(..., precision="single", use_pallas=False)``
and against a numpy f64 dense oracle, on the same triplets and values.

Per case: backward and forward (NONE and FULL) within 2e-6 relative l2
of the JAX result; both within ``predicted_rel_error`` of the oracle; a
second backward identical to the first; a plan rebuilt from the JAX
plan's index arrays (``convert.plan_from_arrays``) identical to the
port's own."""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import spfft_tpu
from spfft_tpu import plan as jplan_mod

import spfft_tpu_torch as sp
from spfft_tpu_torch import convert
from spfft_tpu_torch import plan as tplan_mod

torch.set_num_threads(2)

TOL = 2e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sphere(dims, radius):
    def c(d):
        a = np.arange(d)
        return np.where(a > d // 2, a - d, a)
    X, Y, Z = np.meshgrid(c(dims[0]), c(dims[1]), c(dims[2]), indexing="ij")
    m = X * X + Y * Y + Z * Z <= radius * radius
    return np.stack([X[m], Y[m], Z[m]], axis=1).astype(np.int32)


def _case_triplets(name):
    rng = np.random.default_rng(11)
    if name == "dense2":
        g = np.arange(2)
        X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
        return (2, 2, 2), np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
    if name == "sphere16":
        return (16, 16, 16), _sphere((16, 16, 16), 8)
    if name == "noncubic":
        return (24, 20, 16), _sphere((24, 20, 16), 8)
    if name == "split_x":
        return (24, 20, 16), _sphere((24, 20, 16), 4)
    if name == "shuffled":
        t = _sphere((16, 16, 16), 8)
        return (16, 16, 16), t[rng.permutation(len(t))]
    if name == "duplicates":
        t = _sphere((12, 12, 12), 5)
        return (12, 12, 12), np.concatenate([t, t[rng.integers(0, len(t),
                                                             17)]])
    raise KeyError(name)


CASES = ("dense2", "sphere16", "noncubic", "split_x", "shuffled",
         "duplicates")


def _oracle_backward(dims, trip, vals):
    """Dense f64 unnormalised inverse DFT; duplicates: last one wins."""
    nx, ny, nz = dims
    g = np.zeros((nz, ny, nx), np.complex128)
    t = np.where(trip < 0, trip + np.array(dims), trip)
    g[t[:, 2], t[:, 1], t[:, 0]] = vals
    return np.fft.ifftn(g) * (nx * ny * nz)


def _oracle_forward(dims, trip, space, scale):
    t = np.where(trip < 0, trip + np.array(dims), trip)
    return np.fft.fftn(space)[t[:, 2], t[:, 1], t[:, 0]] * scale


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.complex128) - b)
                 / np.linalg.norm(b))


def _c(a):
    a = np.asarray(a)
    return a[..., 0] + 1j * a[..., 1].astype(np.float64)


@functools.lru_cache(maxsize=None)
def _case(name):
    dims, trip = _case_triplets(name)
    rng = np.random.default_rng(7)
    vals = (rng.standard_normal(len(trip))
            + 1j * rng.standard_normal(len(trip))).astype(np.complex64)
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType.C2C, *dims, trip,
                                   precision="single", use_pallas=False)
    tp = sp.make_local_plan(sp.TransformType.C2C, *dims, trip, device="cpu")
    jb = np.asarray(jp.backward(vals))
    tb = tp.backward(vals).numpy()
    out = {"dims": dims, "trip": trip, "vals": vals, "jp": jp, "tp": tp,
           "jb": jb, "tb": tb}
    for sc in ("none", "full"):
        out["jf_" + sc] = np.asarray(jp.forward(jb, spfft_tpu.Scaling(sc)))
        out["tf_" + sc] = tp.forward(jb, sp.Scaling(sc)).numpy()
    return out


@pytest.mark.parametrize("name", CASES)
def test_backward_matches_jax_and_oracle(name):
    c = _case(name)
    assert c["tb"].shape == c["jb"].shape
    assert _rel(_c(c["tb"]), _c(c["jb"])) <= TOL
    pred = sp.predicted_rel_error("single", max(c["dims"]), True)
    want = _oracle_backward(c["dims"], c["trip"], c["vals"])
    assert _rel(_c(c["tb"]), want) <= pred


@pytest.mark.parametrize("scaling", ["none", "full"])
@pytest.mark.parametrize("name", CASES)
def test_forward_matches_jax_and_oracle(name, scaling):
    c = _case(name)
    got, want = c["tf_" + scaling], c["jf_" + scaling]
    assert got.shape == want.shape == (len(c["trip"]), 2)
    assert _rel(_c(got), _c(want)) <= TOL
    scale = 1.0 / np.prod(c["dims"]) if scaling == "full" else 1.0
    oracle = _oracle_forward(c["dims"], c["trip"],
                             _c(c["jb"]).astype(np.complex128), scale)
    pred = sp.predicted_rel_error("single", max(c["dims"]), True)
    assert _rel(_c(got), oracle) <= pred


@pytest.mark.parametrize("name", CASES)
def test_backward_twice_is_identical(name):
    c = _case(name)
    again = c["tp"].backward(c["vals"]).numpy()
    np.testing.assert_array_equal(again, c["tb"])


@pytest.mark.parametrize("name", CASES)
def test_plan_from_jax_index_arrays(name):
    c = _case(name)
    fields = dataclasses.asdict(c["jp"].index_plan)
    plan = convert.plan_from_arrays(fields, device="cpu")
    np.testing.assert_array_equal(plan.backward(c["vals"]).numpy(), c["tb"])
    np.testing.assert_array_equal(
        plan.forward(c["jb"], sp.Scaling.FULL).numpy(), c["tf_full"])


def test_split_x_window_matches_jax():
    c = _case("split_x")
    assert c["jp"]._split_x is not None
    assert c["tp"].split_x == c["jp"]._split_x
    assert _case("noncubic")["tp"].split_x is None


def test_pair_layout_matches_jax(monkeypatch):
    """Plans at or above PAIR_IO_THRESHOLD take and return (2, N)."""
    monkeypatch.setattr(jplan_mod, "PAIR_IO_THRESHOLD", 0)
    monkeypatch.setattr(tplan_mod, "PAIR_IO_THRESHOLD", 0)
    dims, trip = _case_triplets("noncubic")
    vals = _case("noncubic")["vals"]
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType.C2C, *dims, trip,
                                   precision="single", use_pallas=False)
    tp = sp.make_local_plan(sp.TransformType.C2C, *dims, trip, device="cpu")
    assert jp.pair_values_io and tp.pair_values_io
    pair_in = np.stack([vals.real, vals.imag]).astype(np.float32)
    tb = tp.backward(pair_in).numpy()
    assert _rel(_c(tb), _c(np.asarray(jp.backward(pair_in)))) <= TOL
    np.testing.assert_array_equal(tp.backward(vals).numpy(), tb)
    tf = tp.forward(tb, sp.Scaling.FULL).numpy()
    jf = np.asarray(jp.forward(tb, spfft_tpu.Scaling.FULL))
    assert tf.shape == jf.shape == (2, len(trip))
    assert _rel(tf[0] + 1j * tf[1], jf[0] + 1j * jf[1]) <= TOL


def test_tensor_inputs_on_the_plan_device():
    c = _case("sphere16")
    tp = c["tp"]
    v = torch.from_numpy(c["vals"])
    np.testing.assert_array_equal(tp.backward(v).numpy(), c["tb"])
    np.testing.assert_array_equal(
        tp.backward(torch.view_as_real(v)).numpy(), c["tb"])
    sp_c = torch.view_as_complex(torch.tensor(c["jb"]))
    np.testing.assert_array_equal(tp.forward(sp_c).numpy(), c["tf_none"])


def test_wrong_value_count_raises_like_jax():
    c = _case("sphere16")
    bad = c["vals"][:-1]
    with pytest.raises(spfft_tpu.InvalidParameterError) as je:
        c["jp"].backward(bad)
    with pytest.raises(sp.InvalidParameterError) as te:
        c["tp"].backward(bad)
    assert int(te.value.error_code()) == int(je.value.error_code())
    with pytest.raises(sp.InvalidParameterError):
        c["tp"].forward(np.zeros((3, 3, 3), np.complex64))


def test_unsupported_modes_raise_typed_errors():
    trip = np.array([[0, 0, 0], [1, 0, 0]])
    # axes above MATMUL_DFT_MAX plan, as in the JAX package (the long-axis
    # forms); what stays out of this slice raises below
    for tt in (sp.TransformType.R2C, sp.TransformType.C2C):
        assert sp.make_local_plan(tt, 600, 2, 2, trip,
                                  device="cpu").dim_x == 600
    plan = _case("dense2")["tp"]
    # donate_inputs and the artifact restore are ported; what the port has
    # not (serialised executables, a restore without tables) raises typed
    assert sp.make_local_plan(sp.TransformType.C2C, 4, 4, 4, trip,
                              device="cpu", donate_inputs=True).donate_inputs
    assert sp.TransformPlan(plan.index_plan, device="cpu",
                            donate_inputs=True).donate_inputs
    for call, what in ((lambda: tplan_mod.restore_plan(plan.index_plan,
                                                       None), "PlanTables"),
                       (lambda: plan.install_aot({"backward": object()}),
                        "no serialised executables")):
        with pytest.raises(sp.InvalidParameterError, match=what):
            call()


def test_dtype_helpers_match_jax():
    from spfft_tpu.utils import dtypes as jd
    from spfft_tpu_torch.utils import dtypes as td
    rng = np.random.default_rng(5)
    z = (rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4)))
    for prec in ("single", "double"):
        assert td.real_dtype(prec) == jd.real_dtype(prec)
        assert td.complex_dtype(prec) == jd.complex_dtype(prec)
        il = td.as_interleaved(z, prec)
        np.testing.assert_array_equal(il, jd.as_interleaved(z, prec))
        np.testing.assert_array_equal(td.as_complex_np(il),
                                      jd.as_complex_np(il))
        np.testing.assert_array_equal(
            td.as_complex_np(torch.from_numpy(il)), jd.as_complex_np(il))
    t = torch.from_numpy(td.as_interleaved(z, "single"))
    c = td.interleaved_to_complex(t)
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(jd.interleaved_to_complex(t.numpy())))
    np.testing.assert_array_equal(td.complex_to_interleaved(c).numpy(),
                                  t.numpy())
    with pytest.raises(sp.InvalidParameterError):
        td.real_dtype("half")
    with pytest.raises(sp.InvalidParameterError):
        td.as_interleaved(np.zeros((3, 3)), "single")


def test_no_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    trip = np.array([[0, 0, 0]])
    with pytest.raises(sp.DeviceError):
        sp.make_local_plan(sp.TransformType.C2C, 2, 2, 2, trip)
    with pytest.raises(sp.DeviceError):
        sp.make_local_plan(sp.TransformType.C2C, 2, 2, 2, trip,
                           device="cuda")


def test_port_never_imports_jax():
    """Importing every module of the port — each one
    ``pkgutil.walk_packages`` finds under ``spfft_tpu_torch`` — and
    chip_smoke.py leaves JAX and the JAX package out of sys.modules."""
    code = ("import importlib, pkgutil, sys\n"
            "import spfft_tpu_torch as pkg\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, 'spfft_tpu_torch.')] + ['chip_smoke']\n"
            "assert len(mods) > 30, mods\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'spfft_tpu' or "
            "m.startswith('spfft_tpu.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cpu_plan_refuses_reduced_fp32_matmul():
    """Every complex stage of a ``device="cpu"`` plan is ``torch.matmul``
    (``ops.dft.pdft_last``): under oneDNN's bf16 float32 matmul a whole
    32^3 C2C plan raises ``DeviceError`` in backward and in forward
    instead of returning a result off by about 1e-3, and with the setting
    restored it is within 1e-6 of the dense f64 oracle both ways."""
    mm = getattr(getattr(torch.backends, "mkldnn", None), "matmul", None)
    if mm is None or not hasattr(mm, "fp32_precision"):
        pytest.skip("this PyTorch has no oneDNN fp32_precision setting")
    dims = (32, 32, 32)
    trip = _sphere(dims, 15)
    rng = np.random.default_rng(21)
    vals = (rng.standard_normal(len(trip))
            + 1j * rng.standard_normal(len(trip))).astype(np.complex64)
    plan = sp.make_local_plan(sp.TransformType.C2C, *dims, trip,
                              device="cpu")
    space = torch.from_numpy(np.stack([np.zeros(dims[::-1], np.float32)] * 2,
                                      axis=-1))
    prev = mm.fp32_precision
    mm.fp32_precision = "bf16"
    try:
        with pytest.raises(sp.DeviceError, match="pdft_last"):
            plan.backward(vals)
        with pytest.raises(sp.DeviceError, match="pdft_last"):
            plan.forward(space, sp.Scaling.FULL)
    finally:
        mm.fp32_precision = prev
    got = plan.backward(vals)
    want = _oracle_backward(dims, trip, vals)
    assert _rel(_c(got), want) <= 1e-6
    back = plan.forward(got, sp.Scaling.FULL)
    assert _rel(_c(back), vals) <= 1e-6
