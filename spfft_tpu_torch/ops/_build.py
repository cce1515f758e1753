"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go
to ``build/torch_kernels/`` beside the package, named by a digest of
the sources and flags, so an edited source never loads a stale library.
A build happens at the first use of a kernel in a process, or all at
once through :func:`build`. Each ``nvcc`` run is the package's one
compile: it is recorded as ``obs.record_compile("kernel_build", ...)``
(``spfft_compile_events_total{kind="kernel_build"}`` and its seconds,
and a ``compile.kernel_build`` span when tracing is on). A build that
fails in any way (``nvcc`` missing, failing or running past
:data:`BUILD_TIMEOUT_S`, a library that does not load, an entry it lacks)
raises :class:`~spfft_tpu_torch.errors.KernelBuildError` with the cause
chained, which is not charged to the device.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises :class:`~spfft_tpu_torch.errors.DeviceError` when
it is not 0 (a refused launch never runs, and a later synchronize would not
report it).

Each kernel has one entry per real type, instanced from one template:
``spfft_<name>`` on float32 operands and ``spfft_<name>_f64`` on float64
(:func:`entry`); :data:`REAL_TYPES` are the operand dtypes a kernel
takes, and :func:`call_dtype` checks that every operand of a call shares
one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .. import obs
from ..errors import DeviceError, InvalidParameterError, KernelBuildError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("bluestein.cu", "dft2.cu", "fft.cu", "fft_long.cu",
           "fused_compress.cu", "fused_fft.cu", "gather.cu", "rfft.cu",
           "wire.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600
#: the operand dtypes every kernel takes, and the ctypes type of a scalar
#: of each (a scale argument)
REAL_TYPES = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}

_lock = threading.Lock()
_libs = {}  #: guarded by _lock; source name -> ctypes.CDLL
#: source name -> nvcc's output of the build of its loaded library
#: (ptxas register, spill and shared-memory report), kept beside the
#: library as ``<library>.log``; guarded by _lock
build_log = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of spfft_tpu_torch build from source at first use")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [CSRC / name]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{Path(name).stem}-{h.hexdigest()[:16]}.so"


def _log_path(library: Path) -> Path:
    return library.with_suffix(".log")


def build(names=SOURCES) -> dict:
    """Compile the named sources that have no up-to-date library yet,
    all ``nvcc`` processes at once, and load every named library with its
    build's log (:data:`build_log`). Returns ``{name: seconds}`` for the
    sources compiled by this call. Any failure raises
    :class:`~spfft_tpu_torch.errors.KernelBuildError`."""
    return _build_guarded(tuple(names))[0]


def _build_guarded(names) -> tuple:
    """:func:`_build_locked`, any failure raised as
    :class:`~spfft_tpu_torch.errors.KernelBuildError`."""
    try:
        return _build_locked(names)
    except KernelBuildError:
        raise
    except Exception as exc:
        raise KernelBuildError(
            f"building or loading the kernels of {', '.join(names)} "
            f"failed: {type(exc).__name__}: {exc}") from exc


def _build_locked(names) -> tuple:
    """Build and load ``names`` under :data:`_lock`: ``({name: seconds}
    of the sources compiled, {name: library} of every named source)``,
    both read under the lock."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        out = {n: _library_path(n) for n in todo}
        procs = {}
        try:
            for n in todo:
                if out[n].exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / n)]
                procs[n] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, time.perf_counter())
            seconds = {}
            for n, (proc, tmp, t0) in procs.items():
                try:
                    log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
                except subprocess.TimeoutExpired as exc:
                    obs.record_compile("kernel_build",
                                       time.perf_counter() - t0, t0,
                                       source=n, failed=True)
                    raise KernelBuildError(
                        f"nvcc on csrc/{n} ran past {BUILD_TIMEOUT_S} s"
                    ) from exc
                seconds[n] = time.perf_counter() - t0
                obs.record_compile("kernel_build", seconds[n], t0, source=n,
                                   failed=proc.returncode != 0)
                if proc.returncode != 0:
                    raise KernelBuildError(
                        f"nvcc failed on csrc/{n} (exit {proc.returncode}):"
                        f"\n{log[-4000:]}")
                # the log first: a library on disk always has its log
                tmp_log = tmp.with_suffix(".log.tmp")
                tmp_log.write_text(log)
                os.replace(tmp_log, _log_path(out[n]))
                os.replace(tmp, out[n])
        finally:
            for proc, _, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n in todo:
            _libs[n] = ctypes.CDLL(str(out[n]))
            log = _log_path(out[n])
            if log.exists():
                build_log[n] = log.read_text()
        return seconds, {n: _libs[n] for n in names}


def function(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``source``'s library (built on first
    use), typed with ``argtypes`` and returning the CUDA error code;
    raises :class:`~spfft_tpu_torch.errors.KernelBuildError` when the
    library does not build or load or lacks the entry. The library is
    read under the build's one acquisition of :data:`_lock`."""
    lib = _build_guarded((source,))[1][source]
    try:
        fn = getattr(lib, symbol)
    except AttributeError as exc:
        raise KernelBuildError(
            f"the library of csrc/{source} has no entry {symbol}") from exc
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(fn, what: str, device, *args) -> None:
    """Call the C entry ``fn`` with ``args`` and the raw handle of
    PyTorch's current stream on ``device``, with ``device`` made the
    current device (the entry launches on the current device); raise
    when it reports a CUDA error."""
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise DeviceError(f"{what}: CUDA error {code} at launch")


#: the form of a stage that runs a PyTorch call (``torch.fft``), not a
#: kernel of this package
LIBRARY = "library"


def count(wrapper, form: str) -> None:
    """One launch of ``wrapper``'s kernel in ``form``: adds one to
    ``wrapper.launches`` and to ``wrapper.form_launches[form]`` (a form
    missing from that dict starts at 0). A :data:`LIBRARY` call launches
    no kernel of the package: it adds to its form's count only."""
    if form != LIBRARY:
        wrapper.launches += 1
    wrapper.form_launches[form] = wrapper.form_launches.get(form, 0) + 1


def entry(symbol: str, dtype) -> str:
    """The C entry of ``symbol``'s kernel for operands of ``dtype``:
    ``symbol`` itself for float32, ``symbol + "_f64"`` for float64."""
    return symbol if dtype == torch.float32 else symbol + "_f64"


def call_dtype(t: torch.Tensor, name: str):
    """The dtype of ``t``, one of :data:`REAL_TYPES` (the dtype every
    other operand of the call must share); raises
    :class:`~spfft_tpu_torch.errors.InvalidParameterError` otherwise."""
    dtype = getattr(t, "dtype", None)
    if not isinstance(t, torch.Tensor) or dtype not in REAL_TYPES:
        raise InvalidParameterError(
            f"{name}: expected a torch.float32 or torch.float64 tensor, got "
            f"{dtype if dtype is not None else type(t).__name__}")
    return dtype


def require(t: torch.Tensor, name: str, dtype, shape=None,
            device=None) -> None:
    """The wrappers' operand rules: a contiguous tensor of ``dtype``
    (and ``shape``, and on ``device``, where given); raises
    :class:`~spfft_tpu_torch.errors.InvalidParameterError` otherwise. A
    real operand of another real type than the call's names both: the
    kernels take no mixture of float32 and float64."""
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        got = getattr(t, 'dtype', type(t).__name__)
        mix = " (every operand of a call shares one real type)" \
            if dtype in REAL_TYPES and got in REAL_TYPES else ""
        raise InvalidParameterError(
            f"{name}: expected a {dtype} tensor, got {got}{mix}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise InvalidParameterError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise InvalidParameterError(
            f"{name}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise InvalidParameterError(f"{name}: expected a contiguous tensor")


def require_mats(mats, name: str, dtype, shape, device) -> None:
    """A DFT matrix pair of ``dtype`` and ``shape`` on ``device``, and
    its twiddle table of ``dtype`` where it carries one
    (``ops.dft.DftMats``), whose ``shape`` (where it has one: a stage of
    the two-pass, Bluestein or ``torch.fft`` form holds no pair) is
    ``shape`` too, and its Bluestein tables where it carries them; raises
    :class:`~spfft_tpu_torch.errors.InvalidParameterError` otherwise."""
    for c in mats:
        require(c, f"{name} matrix", dtype, shape, device)
    got = getattr(mats, "shape", None)
    if got is not None and tuple(got) != tuple(shape):
        raise InvalidParameterError(
            f"{name}: expected a DFT stage of shape {tuple(shape)}, got "
            f"{tuple(got)}")
    tw = getattr(mats, "twiddles", None)
    if tw is not None:
        require(tw, f"{name} twiddle table", dtype, (2, mats.n), device)
    bt = getattr(mats, "bluestein", None)
    if bt is not None:
        for t, what, length in ((bt.chirp, "chirp", mats.n),
                                (bt.spectrum, "spectrum", bt.m),
                                (bt.twiddles, "twiddle table", bt.m)):
            require(t, f"{name} Bluestein {what}", dtype, (2, length),
                    device)


def on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise DeviceError(f"{what}: no kernel for device {t.device}")
