"""The port's C ABI (``libspfft_tpu_torch.so``, ``include/spfft_tpu_torch.h``,
``include/spfft_tpu_torch.f90``) on the CPU, with
``SPFFT_TPU_TORCH_DEVICE=cpu``.

* The header and the Fortran module against the JAX package's
  (``include/spfft_tpu.h``): every prototype with the same name, return
  type and argument types, every enumerator with the same value, the same
  ABI version, every Fortran ``bind(C)`` declaration with the header's
  argument count.
* The library, built by ``spfft_tpu_torch.native.build_capi``: every header
  function exported, ``spfft_tpu_abi_version() == 2``; ``examples/example.c``,
  compiled against the JAX header, prints ``OK`` against it, and
  ``native/capi_drive.c`` runs its cases at 16^3 (subprocesses: their own
  embedded interpreter).
* Loaded into this process with ``ctypes`` (it shares the running
  interpreter), its results against the JAX package's Python side of its
  own C ABI (``spfft_tpu.capi_bridge``, the functions ``libspfft_tpu.so``
  calls, given the same caller buffers; ``libspfft_tpu.so`` itself is
  never loaded here): local C2C and R2C in single (2e-6 relative l2) and
  double (``predicted_rel_error("double", n)``), distributed C2C and R2C
  over 4 shards in the concatenated per-shard layout, ``execute_pair`` (in
  place too), ``multi_*`` with one handle and with mixed handles, every
  ``plan_info`` getter; and bit for bit against the port's own Python API
  on the CPU.
* The error surface, as ``tests/test_capi.py`` checks the JAX library's.
* The Fortran module's kinds: every declared function called through
  argument types taken only from them.
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

import spfft_tpu.capi_bridge as jax_bridge

import spfft_tpu_torch as sp
from spfft_tpu_torch import capi_bridge, native
from spfft_tpu_torch import plan as plan_mod
from spfft_tpu_torch.errors import ErrorCode
from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                             round_robin_stick_partition,
                                             sort_triplets_stick_major,
                                             spherical_cutoff_triplets)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HEADER = os.path.join(REPO, "include", "spfft_tpu.h")
HEADER = os.path.join(REPO, "include", "spfft_tpu_torch.h")
JAX_F90 = os.path.join(REPO, "include", "spfft_tpu.f90")
F90 = os.path.join(REPO, "include", "spfft_tpu_torch.f90")

N = 16
SHARDS = 4
TOL = 2e-6
AUTO, OFF, ON = -1, 0, 1
C2C, R2C = 0, 1
SINGLE, DOUBLE = 0, 1
FULL, NONE = 1, 0
INVALID_PARAMETER = int(ErrorCode.INVALID_PARAMETER)


# -- the header, parsed ---------------------------------------------------------

def _strip_comments(src: str) -> str:
    return re.sub(r"/\*.*?\*/", "", src, flags=re.S)


def _norm_type(t: str) -> str:
    return re.sub(r"\s*\*\s*", "*", " ".join(t.split()))


def parse_prototypes(path: str) -> dict:
    """{name: (return type, [argument types])} of every prototype."""
    src = _strip_comments(open(path).read())
    out = {}
    for m in re.finditer(
            r"^\s*(\w[\w\s]*?[\s*]+)(spfft_tpu_\w+)\s*\(([^;]*?)\)\s*;",
            src, re.M | re.S):
        args = [a.strip() for a in m.group(3).split(",")]
        types = [] if args == ["void"] else [
            _norm_type(re.sub(r"\b\w+$", "", a)) for a in args]
        out[m.group(2)] = (_norm_type(m.group(1)), types)
    return out


def parse_constants(path: str) -> dict:
    src = _strip_comments(open(path).read())
    consts = {k: int(v) for k, v in re.findall(
        r"(SPFFT_TPU_\w+)\s*=\s*(-?\d+)", src)}
    consts.update({k: int(v) for k, v in re.findall(
        r"#define\s+(SPFFT_TPU_\w+)\s+(-?\d+)", src)})
    return consts


_CTYPE = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
          "SpfftTpuPlan": ctypes.c_void_p, "const char*": ctypes.c_char_p}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type every function of the header on ``lib``: pointers as
    addresses (``c_void_p``), the rest as the header declares it."""
    for name, (ret, args) in parse_prototypes(HEADER).items():
        fn = getattr(lib, name)
        fn.restype = _CTYPE[ret]
        fn.argtypes = [_CTYPE.get(a, ctypes.c_void_p) for a in args]
    return lib


# -- fixtures -------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    """Every plan of this module on the CPU: plain PyTorch versions."""
    old = os.environ.get(capi_bridge.DEVICE_ENV)
    os.environ[capi_bridge.DEVICE_ENV] = "cpu"
    yield
    if old is None:
        os.environ.pop(capi_bridge.DEVICE_ENV, None)
    else:
        os.environ[capi_bridge.DEVICE_ENV] = old


@pytest.fixture(scope="module")
def lib_path():
    return str(native.build_capi())


@pytest.fixture(scope="module")
def lib(lib_path):
    lib = bind(ctypes.CDLL(lib_path))
    assert lib.spfft_tpu_init(None) == 0
    return lib


def addr(a: np.ndarray) -> int:
    return a.ctypes.data


def ptrs(arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(
        *[a if isinstance(a, int) else addr(a) for a in arrays])


def create(lib, kind, trip, prec=SINGLE, pallas=AUTO, n=N):
    trip = np.ascontiguousarray(trip, np.int32)
    h = ctypes.c_void_p()
    code = lib.spfft_tpu_plan_create(ctypes.addressof(h), kind, n, n, n,
                                     len(trip), addr(trip), prec, pallas)
    assert code == 0, code
    return h.value


def dist_inputs(parts, n=N):
    trip = np.ascontiguousarray(np.concatenate(parts), np.int32)
    vps = np.array([len(p) for p in parts], np.int64)
    pps = np.array(even_plane_split(n, len(parts)), np.int32)
    return trip, vps, pps


def create_dist(lib, kind, parts, prec=SINGLE, pallas=AUTO, exchange=0,
                n=N, expect=0):
    trip, vps, pps = dist_inputs(parts, n)
    h = ctypes.c_void_p()
    code = lib.spfft_tpu_plan_create_distributed(
        ctypes.addressof(h), kind, n, n, n, len(parts), addr(vps),
        addr(trip), addr(pps), prec, exchange, pallas)
    assert code == expect, code
    return h.value


def jax_create(kind, trip, prec=SINGLE, pallas=AUTO, n=N):
    trip = np.ascontiguousarray(trip, np.int32)
    code, pid = jax_bridge.plan_create(kind, n, n, n, len(trip), addr(trip),
                                       prec, pallas)
    assert code == 0
    return pid


def jax_create_dist(kind, parts, prec=SINGLE, pallas=AUTO, n=N):
    trip, vps, pps = dist_inputs(parts, n)
    code, pid = jax_bridge.plan_create_distributed(
        kind, n, n, n, len(parts), addr(vps), addr(trip), addr(pps), prec, 0,
        pallas)
    assert code == 0
    return pid


# -- inputs ---------------------------------------------------------------------

def sphere(n=N):
    return sort_triplets_stick_major(spherical_cutoff_triplets(n), (n, n, n))


def half_sphere(n=N):
    full = spherical_cutoff_triplets(n)
    x, y, z = full.T
    half = full[(x > 0) | ((x == 0) & ((y > 0) | ((y == 0) & (z >= 0))))]
    return sort_triplets_stick_major(half, (n, n, n))


def rdt(prec):
    return np.float32 if prec == SINGLE else np.float64


def c2c_values(trip, prec, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (len(trip), 2)).astype(rdt(prec))


def r2c_values(trip, prec, seed=0, n=N):
    """A real field's spectrum at the half-set triplets, interleaved."""
    spec = np.fft.fftn(np.random.default_rng(seed).standard_normal(
        (n, n, n)))
    v = spec[trip[:, 2] % n, trip[:, 1] % n, trip[:, 0] % n]
    return np.stack([v.real, v.imag], -1).astype(rdt(prec))


def inputs(kind, prec, seed=0):
    trip = sphere() if kind == C2C else half_sphere()
    make = c2c_values if kind == C2C else r2c_values
    return trip, make(trip, prec, seed)


def space_like(kind, prec, n=N):
    return np.empty((n, n, n) + ((2,) if kind == C2C else ()), rdt(prec))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tol(prec) -> float:
    return TOL if prec == SINGLE else sp.predicted_rel_error("double", N)


def port_plan(kind, trip, prec, fused=True):
    return sp.make_local_plan(sp.TransformType.C2C if kind == C2C
                              else sp.TransformType.R2C, N, N, N, trip,
                              precision=("single", "double")[prec],
                              device="cpu", fused=fused)


def run_calls(backward, forward, pair, kind, prec, values):
    """backward, forward(FULL) and forward(NONE) of that space,
    execute_pair(FULL), each into fresh buffers, through the given
    callables (C ABI or the JAX bridge, same signatures)."""
    space = space_like(kind, prec)
    full, none, paired = (np.empty_like(values) for _ in range(3))
    assert backward(addr(values), addr(space)) == 0
    assert forward(addr(space), FULL, addr(full)) == 0
    assert forward(addr(space), NONE, addr(none)) == 0
    assert pair(addr(values), FULL, addr(paired)) == 0
    return space, full, none, paired


def capi_calls(lib, h, kind, prec, values):
    return run_calls(
        lambda v, s: lib.spfft_tpu_backward(h, v, s),
        lambda s, sc, v: lib.spfft_tpu_forward(h, s, sc, v),
        lambda v, sc, o: lib.spfft_tpu_execute_pair(h, v, sc, o),
        kind, prec, values)


def jax_calls(pid, kind, prec, values):
    return run_calls(
        lambda v, s: jax_bridge.backward(pid, v, s)[0],
        lambda s, sc, v: jax_bridge.forward(pid, s, sc, v)[0],
        lambda v, sc, o: jax_bridge.execute_pair(pid, v, sc, o)[0],
        kind, prec, values)


# -- the header and the Fortran module ------------------------------------------

def test_header_prototypes_match_jax_header():
    """Every prototype of include/spfft_tpu.h is in the port's header with
    the same name, return type and argument types, and no other."""
    jax_protos = parse_prototypes(JAX_HEADER)
    protos = parse_prototypes(HEADER)
    assert len(jax_protos) == 25
    assert protos == jax_protos


def test_header_constants_match():
    """Every enumerator of include/spfft_tpu.h has the same value in the
    port's header (the ABI version too); the error enum is the port's
    ``ErrorCode`` plus the C layer's runtime-init code."""
    jax_consts = parse_constants(JAX_HEADER)
    consts = parse_constants(HEADER)
    assert {k: consts.get(k) for k in jax_consts} == jax_consts
    assert consts["SPFFT_TPU_ABI_VERSION"] == 2
    errors = {k: v for k, v in consts.items() if k.endswith("_ERROR")
              or k == "SPFFT_TPU_SUCCESS"}
    assert sorted(errors.values()) == sorted(
        [int(c) for c in ErrorCode] + [100])
    assert set(consts) - set(jax_consts) == {
        k for k in errors if k not in jax_consts}


def parse_f90(path: str) -> dict:
    """{bound name: [(argument, kind declaration, value|out|array)]} of
    every ``bind(C)`` function, in argument order."""
    src = re.sub(r"&\s*\n\s*", " ", open(path).read())
    funcs = {}
    for m in re.finditer(
            r"integer\(c_int\) function (\w+)\s*\(([^)]*)\)\s*"
            r'bind\(C, name="(\w+)"\)(.*?)end function', src, re.S):
        decls = {}
        for line in m.group(4).splitlines():
            dm = re.match(r"\s*(integer\(c_int\)|integer\(c_long_long\)|"
                          r"type\(c_ptr\))\s*(,[^:]*)?::\s*(.*)", line)
            if dm is None:
                continue
            quals = dm.group(2) or ""
            klass = ("array" if "dimension(*)" in quals else
                     "out" if "intent(out)" in quals else
                     "value" if "value" in quals else None)
            assert klass, f"{m.group(3)}: {line.strip()}"
            for name in dm.group(3).split(","):
                decls[name.strip()] = (dm.group(1), klass)
        args = [a.strip() for a in m.group(2).split(",") if a.strip()]
        funcs[m.group(3)] = [(a,) + decls[a] for a in args]
    return funcs


def test_f90_module_matches_header():
    """The Fortran module: named spfft_tpu_torch, every header function
    but the string one bound with the header's argument count, the same
    bind(C) declarations as include/spfft_tpu.f90, every header constant
    with its value."""
    src = open(F90).read()
    assert re.search(r"^module spfft_tpu_torch$", src, re.M)
    f90 = parse_f90(F90)
    protos = parse_prototypes(HEADER)
    assert set(f90) == set(protos) - {"spfft_tpu_error_string"}
    for name, args in f90.items():
        assert len(args) == len(protos[name][1]), name
    assert f90 == parse_f90(JAX_F90)
    consts = {k: int(v) for k, v in re.findall(
        r"parameter\s*::\s*(SPFFT_TPU_\w+)\s*=\s*(-?\d+)", src)}
    assert consts == parse_constants(HEADER)


# -- the library ------------------------------------------------------------------

def test_library_exports_the_header(lib_path):
    """Every header function resolves in the library (a handle of its
    own), and the ABI version is the header's."""
    raw = ctypes.CDLL(lib_path)
    for name in parse_prototypes(JAX_HEADER):
        assert hasattr(raw, name), name
    raw.spfft_tpu_abi_version.restype = ctypes.c_int
    assert raw.spfft_tpu_abi_version() == 2


def test_build_capi_rebuilds_only_when_stale(lib_path):
    """An up-to-date library is kept; one recorded as built by another
    command (another Python's flags, say) is rebuilt."""
    before = os.stat(lib_path).st_mtime_ns
    assert str(native.build_capi()) == lib_path
    assert os.stat(lib_path).st_mtime_ns == before
    stamp = lib_path + ".cmd"
    line = open(stamp).read()
    assert "-Wl,-Bsymbolic" in line and "-shared" in line
    with open(stamp, "w") as f:
        f.write(line.replace("-lpython", "-lotherpython"))
    assert str(native.build_capi()) == lib_path
    assert open(stamp).read() == line
    assert os.stat(lib_path).st_mtime_ns > before


def test_error_strings(lib):
    """Every code of the port's ``ErrorCode`` and the runtime-init code
    has a message of its own."""
    msgs = {int(c): lib.spfft_tpu_error_string(int(c)) for c in ErrorCode}
    msgs[100] = lib.spfft_tpu_error_string(100)
    assert msgs[0] == b"success"
    assert msgs[13] == b"device (CUDA) failure"
    assert all(b"unrecognised" not in m for m in msgs.values())
    assert len(set(msgs.values())) == len(msgs)
    assert b"unrecognised" in lib.spfft_tpu_error_string(9999)


def run_program(path, *args, **env):
    out = subprocess.run([str(path), *map(str, args)], capture_output=True,
                         text=True, timeout=300, env=native.embed_env(**env))
    return out


def test_example_c_drop_in():
    """examples/example.c, compiled against the JAX package's header,
    runs against the port's library and prints OK."""
    exe = native.build_program(os.path.join(REPO, "examples", "example.c"),
                               "example_c")
    out = run_program(exe, SPFFT_TPU_TORCH_DEVICE="cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_no_cuda_device_is_a_device_error():
    """With SPFFT_TPU_TORCH_DEVICE unset and no CUDA device, plan
    creation returns SPFFT_TPU_DEVICE_ERROR: the example stops there and
    runs nothing on the host."""
    exe = native.build_program(os.path.join(REPO, "examples", "example.c"),
                               "example_c")
    env = native.embed_env()
    env.pop(capi_bridge.DEVICE_ENV, None)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 1
    assert "spfft_tpu_plan_create" in out.stderr
    assert "-> device (CUDA) failure" in out.stderr
    assert "SPFFT_TPU_TORCH_DEVICE=cpu" in out.stderr
    assert "OK" not in out.stdout


def test_failed_import_is_runtime_init_error(tmp_path):
    """A library whose interpreter cannot import spfft_tpu_torch (the
    package path names an empty directory, and the repository is not on
    PYTHONPATH) returns SPFFT_TPU_RUNTIME_INIT_ERROR from
    spfft_tpu_init."""
    exe = native.build_program(os.path.join(REPO, "examples", "example.c"),
                               "example_c")
    env = native.embed_env(SPFFT_TPU_TORCH_DEVICE="cpu")
    env["SPFFT_TPU_PACKAGE_PATH"] = str(tmp_path)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in env["PYTHONPATH"].split(os.pathsep) if p != REPO)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 1
    assert "No module named 'spfft_tpu_torch'" in out.stderr
    assert ("spfft_tpu_init(getenv(\"SPFFT_TPU_PACKAGE_PATH\")) -> embedded "
            "Python runtime initialisation failed") in out.stderr


def write_case(path, kind, prec, pallas, trip, values_b, shards=None):
    """A capi_drive case directory (see native/capi_drive.c)."""
    os.makedirs(path)
    n_shards = 0 if shards is None else len(shards[0])
    with open(os.path.join(path, "case.txt"), "w") as f:
        f.write(f"{kind} {N} {N} {N} {prec} {pallas} {n_shards} "
                f"{len(values_b)}\n")
    np.ascontiguousarray(trip, np.int32).tofile(
        os.path.join(path, "triplets.bin"))
    if shards is not None:
        with open(os.path.join(path, "shards.bin"), "wb") as f:
            f.write(shards[0].tobytes() + shards[1].tobytes())
    np.ascontiguousarray(values_b).tofile(os.path.join(path, "values.bin"))


def test_capi_drive_matches_python_api(tmp_path):
    """native/capi_drive.c (its own embedded interpreter) at 16^3: local
    C2C with a batch of 3 under one handle, R2C double on the two-kernel
    route, distributed C2C over 4 shards with a batch of 2; every output
    bit for bit the port's Python API's on the same inputs."""
    exe = native.build_program(native.DRIVE, "capi_drive")
    trip, v = inputs(C2C, SINGLE)
    vb = np.stack([v] + [c2c_values(trip, SINGLE, s) for s in (1, 2)])
    rtrip, rv = inputs(R2C, DOUBLE)
    parts = round_robin_stick_partition(trip, (N, N, N), SHARDS)
    dtrip, vps, pps = dist_inputs(parts)
    dvb = np.stack([c2c_values(dtrip, SINGLE, s) for s in (3, 4)])
    write_case(tmp_path / "c2c", C2C, SINGLE, AUTO, trip, vb)
    write_case(tmp_path / "r2c", R2C, DOUBLE, OFF, rtrip, rv[None])
    write_case(tmp_path / "dist", C2C, SINGLE, AUTO, dtrip, dvb, (vps, pps))
    dirs = [tmp_path / d for d in ("c2c", "r2c", "dist")]
    out = run_program(exe, *dirs, SPFFT_TPU_TORCH_DEVICE="cpu")
    assert out.returncode == 0, out.stderr
    assert len(re.findall(r"^capi_drive .* backward_ms=", out.stdout,
                          re.M)) == 3

    def read(d, name, like, count=1):
        got = np.fromfile(d / name, like.dtype)
        return got.reshape((count,) + like.shape) if count > 1 \
            else got.reshape(like.shape)

    full = sp.Scaling.FULL
    cases = [(dirs[0], port_plan(C2C, trip, SINGLE), vb, None),
             (dirs[1], port_plan(R2C, rtrip, DOUBLE, fused=False), rv[None],
              None),
             (dirs[2], sp.make_distributed_plan(
                 sp.TransformType.C2C, N, N, N, parts, list(pps),
                 mesh=sp.make_mesh(SHARDS, "cpu")), dvb, vps)]
    for d, plan, vals, counts in cases:
        if counts is None:
            bwd = [plan.backward(v).numpy() for v in vals]
            fwd = [plan.forward(s, full).numpy() for s in bwd]
            pair = plan.apply_pointwise(vals[0], scaling=full).numpy()
        else:
            dp = plan.dist_plan
            per = [np.split(v, np.cumsum(counts)[:-1]) for v in vals]
            bwd = [np.concatenate([s[r, :dp.num_planes[r]] for r in
                                   range(SHARDS)])
                   for s in (plan.backward(p).numpy() for p in per)]
            fwd = [np.concatenate([o[r, :c] for r, c in enumerate(counts)])
                   for o in (plan.forward(plan.backward(p), full).numpy()
                             for p in per)]
            o = plan.apply_pointwise(per[0], scaling=full).numpy()
            pair = np.concatenate([o[r, :c] for r, c in enumerate(counts)])
        assert np.array_equal(read(d, "backward.bin", bwd[0]), bwd[0]), d
        assert np.array_equal(read(d, "forward.bin", fwd[0]), fwd[0]), d
        assert np.array_equal(read(d, "pair.bin", pair), pair), d
        if len(vals) > 1:
            b = len(vals)
            assert np.array_equal(read(d, "multi_backward.bin", bwd[0], b),
                                  np.stack(bwd)), d
            assert np.array_equal(read(d, "multi_forward.bin", fwd[0], b),
                                  np.stack(fwd)), d


# -- against the JAX package and the port's Python API ----------------------------

PRECISIONS = [("c2c_single", C2C, SINGLE), ("r2c_single", R2C, SINGLE),
              ("c2c_double", C2C, DOUBLE), ("r2c_double", R2C, DOUBLE)]


@pytest.mark.parametrize("name,kind,prec", PRECISIONS,
                         ids=[p[0] for p in PRECISIONS])
def test_local_against_jax_and_python_api(lib, name, kind, prec):
    """backward, forward (FULL and NONE) and execute_pair through the C
    ABI: within the precision's tolerance of the JAX package's, and bit
    for bit the port's Python API on the same arrays."""
    trip, values = inputs(kind, prec)
    h = create(lib, kind, trip, prec)
    got = capi_calls(lib, h, kind, prec, values)
    pid = jax_create(kind, trip, prec)
    want = jax_calls(pid, kind, prec, values)
    for g, w in zip(got, want):
        assert rel(g, w) <= tol(prec), name
    plan = port_plan(kind, trip, prec)
    space = plan.backward(values)
    py = (space.numpy(), plan.forward(space, sp.Scaling.FULL).numpy(),
          plan.forward(space, sp.Scaling.NONE).numpy(),
          plan.apply_pointwise(values, scaling=sp.Scaling.FULL).numpy())
    for g, p in zip(got, py):
        assert g.dtype == p.dtype and np.array_equal(g, p), name
    assert lib.spfft_tpu_plan_destroy(h) == 0
    assert jax_bridge.plan_destroy(pid)[0] == 0


def test_long_axes_handle_plans_and_matches_jax(lib):
    """A local C2C handle with a 600-long x axis and a 520 z axis, sparse
    sticks: it plans (code 0; before the port ran the long axes, code 5)
    and its backward and forward(FULL) agree with the JAX package's
    bridge within 2e-6."""
    dims = (600, 4, 520)
    rng = np.random.default_rng(5)
    xy = np.stack([rng.integers(0, dims[0], 24), rng.integers(0, dims[1], 24)],
                  1)
    xy = np.unique(xy, axis=0)
    z = np.arange(dims[2])
    trip = np.ascontiguousarray(np.concatenate(
        [np.repeat(xy, len(z), 0), np.tile(z, len(xy))[:, None]], 1),
        np.int32)
    values = c2c_values(trip, SINGLE)
    h = ctypes.c_void_p()
    assert lib.spfft_tpu_plan_create(ctypes.addressof(h), C2C, *dims,
                                     len(trip), addr(trip), SINGLE,
                                     AUTO) == 0
    code, pid = jax_bridge.plan_create(C2C, *dims, len(trip), addr(trip),
                                       SINGLE, AUTO)
    assert code == 0
    shape = dims[::-1] + (2,)
    got, want = (np.empty(shape, np.float32) for _ in range(2))
    assert lib.spfft_tpu_backward(h.value, addr(values), addr(got)) == 0
    assert jax_bridge.backward(pid, addr(values), addr(want))[0] == 0
    assert rel(got, want) <= TOL
    fg, fw = (np.empty_like(values) for _ in range(2))
    assert lib.spfft_tpu_forward(h.value, addr(want), FULL, addr(fg)) == 0
    assert jax_bridge.forward(pid, addr(want), FULL, addr(fw))[0] == 0
    assert rel(fg, fw) <= TOL
    assert lib.spfft_tpu_plan_destroy(h.value) == 0
    assert jax_bridge.plan_destroy(pid)[0] == 0


@pytest.mark.parametrize("kind", [C2C, R2C], ids=["c2c", "r2c"])
def test_distributed_against_jax_and_python_api(lib, kind):
    """A distributed plan over 4 shards (round-robin sticks, even slabs)
    in the C layout — per-shard values concatenated, the full cube in
    global z order — against the JAX package's, and bit for bit against
    the port's distributed plan."""
    trip, _ = inputs(kind, SINGLE)
    parts = round_robin_stick_partition(trip, (N, N, N), SHARDS)
    dtrip, vps, pps = dist_inputs(parts)
    values = (c2c_values if kind == C2C else r2c_values)(dtrip, SINGLE)
    h = create_dist(lib, kind, parts)
    got = capi_calls(lib, h, kind, SINGLE, values)
    pid = jax_create_dist(kind, parts)
    want = jax_calls(pid, kind, SINGLE, values)
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL
    plan = sp.make_distributed_plan(
        sp.TransformType(("c2c", "r2c")[kind]), N, N, N, parts, list(pps),
        mesh=sp.make_mesh(SHARDS, "cpu"))
    per = np.split(values, np.cumsum(vps)[:-1])
    space = plan.backward(per)
    cube = np.concatenate([space[r, :n].numpy()
                           for r, n in enumerate(pps)])
    assert np.array_equal(got[0], cube)
    out = plan.forward(space, sp.Scaling.FULL).numpy()
    assert np.array_equal(got[1], np.concatenate(
        [out[r, :c] for r, c in enumerate(vps)]))
    # the local plan of the same values: the same transform
    local = create(lib, kind, dtrip)
    lspace = space_like(kind, SINGLE)
    assert lib.spfft_tpu_backward(local, addr(values), addr(lspace)) == 0
    assert rel(got[0], lspace) <= TOL
    for handle in (h, local):
        assert lib.spfft_tpu_plan_destroy(handle) == 0
    assert jax_bridge.plan_destroy(pid)[0] == 0


@pytest.mark.parametrize("dist", [False, True], ids=["local", "dist"])
def test_execute_pair_in_place(lib, dist):
    """execute_pair with out == in equals the pair into another buffer;
    NONE scaling is N^3 times the values."""
    trip, values = inputs(C2C, SINGLE, seed=5)
    if dist:
        parts = round_robin_stick_partition(trip, (N, N, N), SHARDS)
        trip = np.concatenate(parts)
        values = c2c_values(trip, SINGLE, 5)
        h = create_dist(lib, C2C, parts)
    else:
        h = create(lib, C2C, trip)
    other = np.empty_like(values)
    assert lib.spfft_tpu_execute_pair(h, addr(values), FULL,
                                      addr(other)) == 0
    inplace = values.copy()
    assert lib.spfft_tpu_execute_pair(h, addr(inplace), FULL,
                                      addr(inplace)) == 0
    assert np.array_equal(inplace, other)
    assert rel(other, values) <= TOL
    assert lib.spfft_tpu_execute_pair(h, addr(values), NONE,
                                      addr(other)) == 0
    assert rel(other, values * N ** 3) <= TOL
    assert lib.spfft_tpu_plan_destroy(h) == 0


def test_multi_shared_and_mixed_handles(lib):
    """multi_backward / multi_forward: one local handle for 3 transforms
    (one batched execution), and mixed handles (two local plans and a
    distributed one); each entry against the JAX bridge's multi entries
    on the same buffers and bit for bit against single calls."""
    trip, _ = inputs(C2C, SINGLE)
    parts = round_robin_stick_partition(trip, (N, N, N), SHARDS)
    dtrip = np.concatenate(parts)
    h1, h2 = create(lib, C2C, trip), create(lib, C2C, trip, pallas=OFF)
    hd = create_dist(lib, C2C, parts)
    j1, j2 = jax_create(C2C, trip), jax_create(C2C, trip, pallas=OFF)
    jd = jax_create_dist(C2C, parts)
    for handles, jhandles, trips in (
            ([h1] * 3, [j1] * 3, [trip] * 3),
            ([h1, hd, h2], [j1, jd, j2], [trip, dtrip, trip])):
        vals = [c2c_values(t, SINGLE, 10 + i) for i, t in enumerate(trips)]
        spaces = [space_like(C2C, SINGLE) for _ in vals]
        outs = [np.empty_like(v) for v in vals]
        assert lib.spfft_tpu_multi_backward(
            len(vals), ptrs(handles), ptrs(vals), ptrs(spaces)) == 0
        assert lib.spfft_tpu_multi_forward(
            len(vals), ptrs(handles), ptrs(spaces), FULL, ptrs(outs)) == 0
        jspaces = [space_like(C2C, SINGLE) for _ in vals]
        jouts = [np.empty_like(v) for v in vals]
        jp, jv, js, jo = (ptrs(a) for a in (jhandles, vals, jspaces, jouts))
        assert jax_bridge.multi_backward(
            len(vals), ctypes.addressof(jp), ctypes.addressof(jv),
            ctypes.addressof(js))[0] == 0
        assert jax_bridge.multi_forward(
            len(vals), ctypes.addressof(jp), ctypes.addressof(js), FULL,
            ctypes.addressof(jo))[0] == 0
        for h, v, s, o, jsp, jou in zip(handles, vals, spaces, outs,
                                        jspaces, jouts):
            assert rel(s, jsp) <= TOL and rel(o, jou) <= TOL
            one_s, one_o = space_like(C2C, SINGLE), np.empty_like(v)
            assert lib.spfft_tpu_backward(h, addr(v), addr(one_s)) == 0
            assert lib.spfft_tpu_forward(h, addr(one_s), FULL,
                                         addr(one_o)) == 0
            assert np.array_equal(s, one_s) and np.array_equal(o, one_o)
    for h in (h1, h2, hd):
        assert lib.spfft_tpu_plan_destroy(h) == 0


def test_pair_layout_plan_keeps_interleaved_buffers(lib, monkeypatch):
    """A plan above the pair-layout threshold computes on planar (2, N)
    values; its C buffers stay interleaved rows, equal bit for bit to a
    plan below it, the shared-handle batch included."""
    trip, values = inputs(C2C, SINGLE, seed=7)
    h = create(lib, C2C, trip)
    monkeypatch.setattr(plan_mod, "PAIR_IO_THRESHOLD", 1)
    hp = create(lib, C2C, trip)
    pid = max(capi_bridge._plans)
    assert capi_bridge._plans[pid].pair_values_io
    got = [capi_calls(lib, x, C2C, SINGLE, values) for x in (h, hp)]
    for a, b in zip(*got):
        assert np.array_equal(a, b)
    vals = [values, c2c_values(trip, SINGLE, 8)]
    res = []
    for x in (h, hp):
        spaces = [space_like(C2C, SINGLE) for _ in vals]
        outs = [np.empty_like(v) for v in vals]
        assert lib.spfft_tpu_multi_backward(2, ptrs([x, x]), ptrs(vals),
                                            ptrs(spaces)) == 0
        assert lib.spfft_tpu_multi_forward(2, ptrs([x, x]), ptrs(spaces),
                                           FULL, ptrs(outs)) == 0
        res.append(spaces + outs)
    for a, b in zip(*res):
        assert np.array_equal(a, b)
    for x in (h, hp):
        assert lib.spfft_tpu_plan_destroy(x) == 0


GETTERS = [("spfft_tpu_plan_dim_x", 0, "i"), ("spfft_tpu_plan_dim_y", 1, "i"),
           ("spfft_tpu_plan_dim_z", 2, "i"),
           ("spfft_tpu_plan_num_values", 3, "l"),
           ("spfft_tpu_plan_transform_type", 4, "i"),
           ("spfft_tpu_plan_num_shards", 5, "i"),
           ("spfft_tpu_plan_global_size", 6, "l"),
           ("spfft_tpu_plan_num_global_elements", 7, "l"),
           ("spfft_tpu_plan_local_z_offset", 8, "is"),
           ("spfft_tpu_plan_local_z_length", 9, "is"),
           ("spfft_tpu_plan_local_slice_size", 10, "ls"),
           ("spfft_tpu_plan_num_local_elements", 11, "ls"),
           ("spfft_tpu_plan_exchange_type", 12, "i"),
           ("spfft_tpu_plan_pallas_active", 13, "i")]


def getter(lib, name, sig, h, shard):
    out = (ctypes.c_int if sig[0] == "i" else ctypes.c_longlong)(-1)
    args = (h, shard, ctypes.addressof(out)) if sig.endswith("s") \
        else (h, ctypes.addressof(out))
    code = getattr(lib, name)(*args)
    return code, out.value


@pytest.mark.parametrize("pallas", [AUTO, OFF, ON], ids=["auto", "off", "on"])
@pytest.mark.parametrize("dist", [False, True], ids=["local", "dist"])
def test_plan_info_against_jax(lib, dist, pallas):
    """Every getter, every shard, against the JAX bridge's plan_info on
    the same plan. ``pallas_active`` reports the port's fused route (1
    for AUTO and ON, 0 for OFF), which runs on every device; the JAX
    package's Pallas kernels stay off on its CPU backend where the port
    reports 1."""
    trip, _ = inputs(R2C, SINGLE)
    if dist:
        parts = round_robin_stick_partition(trip, (N, N, N), SHARDS)
        h = create_dist(lib, R2C, parts, pallas=pallas)
        pid = jax_create_dist(R2C, parts, pallas=pallas)
    else:
        h = create(lib, R2C, trip, pallas=pallas)
        pid = jax_create(R2C, trip, pallas=pallas)
    shards = SHARDS if dist else 1
    for name, what, sig in GETTERS:
        for shard in range(shards if sig.endswith("s") else 1):
            code, got = getter(lib, name, sig, h, shard)
            assert code == 0, name
            if what == 13:
                assert got == int(pallas != OFF), name
                if pallas == OFF:
                    assert got == jax_bridge.plan_info(pid, what, shard)[1]
            else:
                assert (0, got) == jax_bridge.plan_info(pid, what, shard), \
                    (name, shard)
        if sig.endswith("s"):
            assert getter(lib, name, sig, h, shards)[0] == INVALID_PARAMETER
            assert getter(lib, name, sig, h, -1)[0] == INVALID_PARAMETER
    assert lib.spfft_tpu_plan_destroy(h) == 0
    assert jax_bridge.plan_destroy(pid)[0] == 0


# -- the error surface ------------------------------------------------------------

def test_invalid_handle(lib):
    """Every entry that takes a handle returns 2 for one it never issued,
    and for one destroyed."""
    trip, values = inputs(C2C, SINGLE)
    h = create(lib, C2C, trip)
    assert lib.spfft_tpu_plan_destroy(h) == 0
    buf = np.empty((N, N, N, 2), np.float32)
    for bad in (12345, h):
        assert lib.spfft_tpu_plan_destroy(bad) == 2
        assert lib.spfft_tpu_backward(bad, addr(values), addr(buf)) == 2
        assert lib.spfft_tpu_forward(bad, addr(buf), FULL, addr(values)) == 2
        assert lib.spfft_tpu_execute_pair(bad, addr(values), FULL,
                                          addr(values)) == 2
        assert lib.spfft_tpu_multi_backward(1, ptrs([bad]), ptrs([values]),
                                            ptrs([buf])) == 2
        for name, _, sig in GETTERS:
            assert getter(lib, name, sig, bad, 0)[0] == 2, name


def test_null_arguments(lib):
    trip, values = inputs(C2C, SINGLE)
    assert lib.spfft_tpu_plan_create(None, 0, N, N, N, 0, None, 0, -1) == 5
    h = ctypes.c_void_p()
    assert lib.spfft_tpu_plan_create(ctypes.addressof(h), 0, N, N, N,
                                     len(trip), None, 0, -1) == 5
    h = create(lib, C2C, trip)
    buf = np.empty((N, N, N, 2), np.float32)
    assert lib.spfft_tpu_backward(h, None, addr(buf)) == 5
    assert lib.spfft_tpu_forward(h, addr(buf), FULL, None) == 5
    assert lib.spfft_tpu_execute_pair(h, None, FULL, None) == 5
    assert lib.spfft_tpu_multi_backward(1, ptrs([h]), ptrs([0]),
                                        ptrs([buf])) == 5
    assert lib.spfft_tpu_multi_forward(0, ptrs([h]), ptrs([buf]), FULL,
                                       ptrs([values])) == 5
    assert lib.spfft_tpu_plan_dim_x(h, None) == 5
    assert lib.spfft_tpu_plan_destroy(h) == 0


def test_invalid_duplicate_and_overflow_indices(lib):
    """An out-of-bounds triplet -> 7, a z-stick on two shards -> 6, a grid
    past the 64-bit size range -> 3: the codes of the JAX package on the
    same calls."""
    bad = np.array([[99, 0, 0]], np.int32)
    h = ctypes.c_void_p()
    code = lib.spfft_tpu_plan_create(ctypes.addressof(h), 0, 4, 4, 4, 1,
                                     addr(bad), 0, -1)
    assert code == 7 == jax_bridge.plan_create(0, 4, 4, 4, 1, addr(bad), 0,
                                               -1)[0]
    assert b"out of bounds" in lib.spfft_tpu_error_string(code)
    one = np.zeros((1, 3), np.int32)
    n = 1 << 21
    assert lib.spfft_tpu_plan_create(ctypes.addressof(h), 0, n, n, n, 1,
                                     addr(one), 0, -1) == 3
    assert jax_bridge.plan_create(0, n, n, n, 1, addr(one), 0, -1)[0] == 3
    stick = np.array([[1, 2, z] for z in range(N)], np.int32)
    parts = [stick, stick, np.zeros((0, 3), np.int32),
             np.zeros((0, 3), np.int32)]
    create_dist(lib, C2C, parts, expect=6)
    trip, vps, pps = dist_inputs(parts)
    assert jax_bridge.plan_create_distributed(
        0, N, N, N, SHARDS, addr(vps), addr(trip), addr(pps), 0, 0,
        -1)[0] == 6


def test_bad_enums(lib):
    trip, values = inputs(C2C, SINGLE)
    t = np.ascontiguousarray(trip, np.int32)
    h = ctypes.c_void_p()
    for kind, prec, pallas in ((7, 0, -1), (0, 3, -1), (0, 0, 5)):
        assert lib.spfft_tpu_plan_create(ctypes.addressof(h), kind, N, N, N,
                                         len(t), addr(t), prec,
                                         pallas) == 5
    parts = round_robin_stick_partition(trip, (N, N, N), SHARDS)
    create_dist(lib, C2C, parts, exchange=42, expect=5)
    h = create(lib, C2C, trip)
    buf = np.empty((N, N, N, 2), np.float32)
    assert lib.spfft_tpu_backward(h, addr(values), addr(buf)) == 0
    assert lib.spfft_tpu_forward(h, addr(buf), 7, addr(values)) == 5
    assert lib.spfft_tpu_execute_pair(h, addr(values), 7, addr(values)) == 5
    assert lib.spfft_tpu_multi_forward(1, ptrs([h]), ptrs([buf]), 7,
                                       ptrs([values])) == 5
    assert lib.spfft_tpu_plan_destroy(h) == 0


def test_shard_counts(lib):
    """No shards -> 5. More shards than the JAX package has devices (64 on
    its 8 virtual ones) -> 5 there; the port holds all its shards on one
    device, so it takes them, and its backward equals the local plan's."""
    trip = np.array([[0, 0, 0], [0, 0, 1]], np.int32)
    values = c2c_values(trip, SINGLE)
    vps, pps = np.zeros(64, np.int64), np.zeros(64, np.int32)
    vps[0], pps[0] = 2, 4
    h = ctypes.c_void_p()
    for shards, expect in ((0, 5), (64, 0)):
        assert lib.spfft_tpu_plan_create_distributed(
            ctypes.addressof(h), 0, 4, 4, 4, shards, addr(vps), addr(trip),
            addr(pps), 0, 0, -1) == expect
    assert jax_bridge.plan_create_distributed(
        0, 4, 4, 4, 64, addr(vps), addr(trip), addr(pps), 0, 0, -1)[0] == 5
    cube, lcube = (np.empty((4, 4, 4, 2), np.float32) for _ in range(2))
    assert lib.spfft_tpu_backward(h.value, addr(values), addr(cube)) == 0
    local = create(lib, C2C, trip, n=4)
    assert lib.spfft_tpu_backward(local, addr(values), addr(lcube)) == 0
    assert rel(cube, lcube) <= TOL
    for x in (h.value, local):
        assert lib.spfft_tpu_plan_destroy(x) == 0


@pytest.mark.parametrize("exchange", [2, 3, 4, 5])
def test_refused_exchange_is_invalid_parameter(lib, exchange, capfd):
    """The exchanges the port does not run come back as code 5, with the
    port's message on stderr."""
    trip, _ = inputs(C2C, SINGLE)
    parts = round_robin_stick_partition(trip, (N, N, N), SHARDS)
    create_dist(lib, C2C, parts, exchange=exchange, expect=5)
    err = capfd.readouterr().err
    assert "InvalidParameterError" in err
    assert "is not in this slice of spfft_tpu_torch" in err


def test_unknown_device_is_invalid_parameter(lib, monkeypatch, capfd):
    trip, _ = inputs(C2C, SINGLE)
    monkeypatch.setenv(capi_bridge.DEVICE_ENV, "tpu")
    t = np.ascontiguousarray(trip, np.int32)
    h = ctypes.c_void_p()
    assert lib.spfft_tpu_plan_create(ctypes.addressof(h), 0, N, N, N, len(t),
                                     addr(t), 0, -1) == 5
    assert "SPFFT_TPU_TORCH_DEVICE must be 'cuda' or 'cpu', got 'tpu'" in \
        capfd.readouterr().err


# -- the Fortran module's kinds ---------------------------------------------------

_F90_KIND = {
    ("integer(c_int)", "value"): ctypes.c_int32,
    ("integer(c_long_long)", "value"): ctypes.c_longlong,
    ("type(c_ptr)", "value"): ctypes.c_void_p,
    ("integer(c_int)", "out"): ctypes.POINTER(ctypes.c_int32),
    ("integer(c_long_long)", "out"): ctypes.POINTER(ctypes.c_longlong),
    ("type(c_ptr)", "out"): ctypes.POINTER(ctypes.c_void_p),
    ("integer(c_int)", "array"): ctypes.POINTER(ctypes.c_int32),
    ("integer(c_long_long)", "array"): ctypes.POINTER(ctypes.c_longlong),
    ("type(c_ptr)", "array"): ctypes.POINTER(ctypes.c_void_p),
}


def test_fortran_kinds_drive_every_function(lib_path):
    """Every function the Fortran module declares, called through
    argument types taken only from its kinds (a kind of the wrong width
    marshals wrongly and the numbers break), on a local and a distributed
    plan."""
    flib = ctypes.CDLL(lib_path)  # a handle of its own: its own typing
    sigs = parse_f90(F90)
    for name, args in sigs.items():
        fn = getattr(flib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [_F90_KIND[(kind, klass)] for _, kind, klass in args]
    called = set()

    def call(name, *args):
        called.add(name)
        assert getattr(flib, name)(*args) == 0, name

    assert flib.spfft_tpu_abi_version() == 2
    called.add("spfft_tpu_abi_version")
    call("spfft_tpu_init", None)
    trip, values = inputs(C2C, SINGLE, seed=11)
    trip = np.ascontiguousarray(trip, np.int32)
    nv = len(trip)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_longlong)
    plan = ctypes.c_void_p()
    call("spfft_tpu_plan_create", ctypes.byref(plan), 0, N, N, N, nv,
         trip.ctypes.data_as(i32), 0, -1)
    out_i, out_l = ctypes.c_int32(), ctypes.c_longlong()
    for name, expect in (("spfft_tpu_plan_dim_x", N),
                         ("spfft_tpu_plan_dim_y", N),
                         ("spfft_tpu_plan_dim_z", N),
                         ("spfft_tpu_plan_transform_type", 0),
                         ("spfft_tpu_plan_num_shards", 1),
                         ("spfft_tpu_plan_exchange_type", 0),
                         ("spfft_tpu_plan_pallas_active", 1)):
        call(name, plan, ctypes.byref(out_i))
        assert out_i.value == expect, name
    for name, expect in (("spfft_tpu_plan_num_values", nv),
                         ("spfft_tpu_plan_global_size", N ** 3),
                         ("spfft_tpu_plan_num_global_elements", nv)):
        call(name, plan, ctypes.byref(out_l))
        assert out_l.value == expect, name
    for name, expect in (("spfft_tpu_plan_local_z_offset", 0),
                         ("spfft_tpu_plan_local_z_length", N)):
        call(name, plan, 0, ctypes.byref(out_i))
        assert out_i.value == expect, name
    for name, expect in (("spfft_tpu_plan_local_slice_size", N ** 3),
                         ("spfft_tpu_plan_num_local_elements", nv)):
        call(name, plan, 0, ctypes.byref(out_l))
        assert out_l.value == expect, name
    space = space_like(C2C, SINGLE)
    out = np.empty_like(values)
    call("spfft_tpu_backward", plan, addr(values), addr(space))
    call("spfft_tpu_forward", plan, addr(space), FULL, addr(out))
    assert rel(out, values) <= TOL
    call("spfft_tpu_execute_pair", plan, addr(values), FULL, addr(out))
    assert rel(out, values) <= TOL
    vals = [values, 2 * values]
    spaces = [space_like(C2C, SINGLE) for _ in vals]
    outs = [np.empty_like(v) for v in vals]
    call("spfft_tpu_multi_backward", 2, ptrs([plan.value] * 2), ptrs(vals),
         ptrs(spaces))
    call("spfft_tpu_multi_forward", 2, ptrs([plan.value] * 2), ptrs(spaces),
         FULL, ptrs(outs))
    assert rel(outs[1], 2 * values) <= TOL
    parts = round_robin_stick_partition(trip, (N, N, N), 2)
    dtrip, vps, pps = dist_inputs(parts)
    dplan = ctypes.c_void_p()
    call("spfft_tpu_plan_create_distributed", ctypes.byref(dplan), 0, N, N,
         N, 2, vps.ctypes.data_as(i64), dtrip.ctypes.data_as(i32),
         pps.ctypes.data_as(i32), 0, 0, -1)
    call("spfft_tpu_plan_num_shards", dplan, ctypes.byref(out_i))
    assert out_i.value == 2
    call("spfft_tpu_plan_local_z_length", dplan, 1, ctypes.byref(out_i))
    assert out_i.value == pps[1]
    call("spfft_tpu_plan_num_local_elements", dplan, 1, ctypes.byref(out_l))
    assert out_l.value == vps[1]
    call("spfft_tpu_plan_destroy", dplan)
    call("spfft_tpu_plan_destroy", plan)
    assert called == set(sigs)
