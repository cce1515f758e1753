"""Build of the port's C ABI: ``libspfft_tpu_torch.so`` and the C
programs that link it.

:func:`build_capi` compiles ``capi.cpp`` (an embedded CPython that imports
:mod:`spfft_tpu_torch.capi_bridge`) with ``g++`` into
``build/torch_capi/libspfft_tpu_torch.so`` at the repository root. The
library exports the symbols of ``include/spfft_tpu.h`` with the same
signatures (ABI version 2), declared for this port in
``include/spfft_tpu_torch.h``. Python's include and link flags come from
``sysconfig`` (``INCLUDEPY``, ``LIBDIR``, ``LDLIBRARY``,
``Py_ENABLE_SHARED``): a C program that embeds the interpreter needs a
shared ``libpython``, and ``python3-config`` is not installed everywhere.

:func:`build_program` compiles a C program (``examples/example.c``, or
``capi_drive.c`` beside this file, the C drive ``chip_smoke.py`` runs on
the card) against that library; :func:`embed_env` is the environment such
a program needs to import ``torch`` and this package.

Nothing here runs at import: a build happens when it is asked for.
"""

from __future__ import annotations

import os
import site
import subprocess
import sysconfig
import threading
from pathlib import Path

from ..errors import HostExecutionError

ROOT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parent / "capi.cpp"
DRIVE = Path(__file__).resolve().parent / "capi_drive.c"
INCLUDE = ROOT / "include"
HEADER = INCLUDE / "spfft_tpu_torch.h"
BUILD_DIR = ROOT / "build" / "torch_capi"
LIBRARY = BUILD_DIR / "libspfft_tpu_torch.so"
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()


def python_flags() -> tuple:
    """``(compile flags, link flags)`` that embed this interpreter's
    Python; raises :class:`~spfft_tpu_torch.errors.HostExecutionError`
    where it has no shared ``libpython``."""
    cfg = sysconfig.get_config_var
    ldlibrary = cfg("LDLIBRARY") or ""
    if not cfg("Py_ENABLE_SHARED") or not ldlibrary.endswith(".so"):
        raise HostExecutionError(
            f"this Python has no shared libpython (Py_ENABLE_SHARED="
            f"{cfg('Py_ENABLE_SHARED')}, LDLIBRARY={ldlibrary!r}); the C ABI "
            f"embeds the interpreter and needs one")
    libdirs = [d for d in (cfg("LIBDIR"), cfg("LIBPL"))
               if d and (Path(d) / ldlibrary).exists()]
    if not libdirs:
        raise HostExecutionError(
            f"{ldlibrary} not found in LIBDIR={cfg('LIBDIR')!r} or "
            f"LIBPL={cfg('LIBPL')!r}")
    name = ldlibrary[len("lib"):-len(".so")]
    return ([f"-I{cfg('INCLUDEPY')}"],
            [f"-L{libdirs[0]}", f"-l{name}", f"-Wl,-rpath,{libdirs[0]}"])


def _build(cmd: list, out: Path, *deps: Path) -> None:
    """Run ``cmd`` (a ``g++`` line, less its ``-o``) into ``out`` unless
    ``out`` is newer than every one of ``deps`` and was built by this
    same command (kept beside it in ``<out>.cmd``: a library built for
    another Python, or a program linked to a library elsewhere, is
    rebuilt). The compiler writes a temporary file that is then moved
    into place, so a concurrent process never loads a half-written file;
    a failure raises with the compiler's output."""
    stamp = out.with_name(out.name + ".cmd")
    line = " ".join(cmd)
    if out.exists() and stamp.exists() and stamp.read_text() == line \
            and out.stat().st_mtime >= max(d.stat().st_mtime for d in deps):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                              text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise HostExecutionError(
                f"g++ failed (exit {proc.returncode}): {line}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        stamp.write_text(line)
    finally:
        if tmp.exists():
            tmp.unlink()


def build_capi() -> Path:
    """Compile ``capi.cpp`` into :data:`LIBRARY` unless it is up to date
    (newer than the source and the header, and built by the same
    command); return its path."""
    cflags, ldflags = python_flags()
    with _lock:
        _build(["g++", "-O3", "-std=c++17", "-Wall", "-shared", "-fPIC",
                f"-I{INCLUDE}", *cflags, str(SOURCE), *ldflags,
                "-Wl,-Bsymbolic"], LIBRARY, SOURCE, HEADER)
    return LIBRARY


def build_program(source, name: str) -> Path:
    """Compile the C program ``source`` with ``g++`` (``include/`` on the
    include path) into ``build/torch_capi/<name>``, linked against the
    port's library (built first), unless it is up to date; return its
    path."""
    lib = build_capi()
    out = BUILD_DIR / name
    source = Path(source)
    with _lock:
        _build(["g++", "-O2", f"-I{INCLUDE}", str(source), f"-L{BUILD_DIR}",
                "-lspfft_tpu_torch", "-lm", f"-Wl,-rpath,{BUILD_DIR}"], out,
               source, lib)
    return out


def embed_env(**extra) -> dict:
    """The environment of a C program that embeds the port's library:
    this one, with ``SPFFT_TPU_PACKAGE_PATH`` the repository root (what
    ``examples/example.c`` hands ``spfft_tpu_init``) and the repository
    root and this interpreter's site directories (where ``torch`` is)
    first on ``PYTHONPATH``; ``extra`` entries are added last."""
    paths = [str(ROOT), *site.getsitepackages()]
    if os.environ.get("PYTHONPATH"):
        paths.append(os.environ["PYTHONPATH"])
    return dict(os.environ, SPFFT_TPU_PACKAGE_PATH=str(ROOT),
                PYTHONPATH=os.pathsep.join(paths), **extra)
