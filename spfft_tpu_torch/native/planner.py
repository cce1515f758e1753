"""The native index planner: ``planner.cpp`` built with ``g++`` at first
use and bound with ``ctypes``.

Two entries, the C ABI of the JAX package's planner library:

* :func:`plan_indices` — the core of
  :func:`~spfft_tpu_torch.indexing.convert_index_triplets`: bounds, the
  ascending unique stick keys and every value's slot ``stick_id * dim_z
  + z``, in one dense bitmap-rank pass (O(n + dim_x * dim_y));
* :func:`inverse_map` — the scatter of iota behind
  :func:`~spfft_tpu_torch.indexing.inverse_slot_map` and
  :func:`~spfft_tpu_torch.indexing.inverse_col_map`, the last duplicate
  winning.

The library builds into ``build/torch_native/`` at the repository root
(``g++ -O3 -std=c++17 -fopenmp -shared -fPIC``) through a temporary file
renamed into place, so processes that race on the first use (pytest
workers, the ranks of one plan) never load a half-written file; it is
rebuilt when the source is newer or the command differs. Nothing builds
at import. Where ``g++`` or the library fails, :func:`unavailable_reason`
says why and the callers take the numpy path, which records that reason
in the plan (``IndexPlan.planner_reason``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..errors import HostExecutionError
from . import ROOT, _build

SOURCE = Path(__file__).resolve().parent / "planner.cpp"
BUILD_DIR = ROOT / "build" / "torch_native"
LIBRARY = BUILD_DIR / "libspfft_tpu_torch_planner.so"
COMMAND = ["g++", "-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC",
           str(SOURCE)]

#: the C entries' error codes (planner.cpp): an index out of bounds, more
#: values than grid elements, and a grid too large for the dense bitmap
ERR_INVALID_BOUNDS = -1
ERR_TOO_MANY_VALUES = -2
ERR_NO_NATIVE_PATH = -3

_lock = threading.Lock()
#: guarded by _lock: the bound library, or the reason it is not there
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.spfft_tpu_plan_indices.restype = ctypes.c_int64
    lib.spfft_tpu_plan_indices.argtypes = [
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.spfft_tpu_inverse_map.restype = ctypes.c_int32
    lib.spfft_tpu_inverse_map.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build (if stale) and bind the library once per process; None,
    with the reason kept, where that fails."""
    global _lib, _reason
    with _lock:
        if _lib is None and _reason is None:
            try:
                _build(COMMAND, LIBRARY, SOURCE)
                _lib = _bind(ctypes.CDLL(str(LIBRARY)))
            except (HostExecutionError, OSError, AttributeError) as exc:
                _reason = (f"the native planner is unavailable: "
                           f"{str(exc).splitlines()[0]}")
        return _lib


def unavailable_reason() -> Optional[str]:
    """None where the library loads, else why it does not."""
    _load()
    return _reason


def plan_indices(hermitian: bool, dim_x: int, dim_y: int, dim_z: int,
                 triplets: np.ndarray):
    """The native conversion of ``(n, 3)`` integer triplets (no hermitian
    x < 0 half: the caller folds that set on the numpy path). Returns
    ``(status, value_indices, stick_keys, centered)``: ``status`` the
    stick count, or one of the ``ERR_*`` codes (then the tables are
    meaningless); ``value_indices`` int32 ``(n,)``, ``stick_keys`` int32
    ``(num_sticks,)``; ``centered`` whether any index is negative (set
    before the bounds check, so an out-of-bounds error can name it).
    None where the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(triplets, dtype=np.int64)
    n = xyz.shape[0]
    value_indices = np.empty(n, np.int32)
    stick_keys = np.empty(max(n, 1), np.int32)
    centered = ctypes.c_int32(0)
    status = int(lib.spfft_tpu_plan_indices(
        ctypes.c_int32(1 if hermitian else 0), dim_x, dim_y, dim_z,
        xyz.ctypes.data, n, value_indices.ctypes.data,
        stick_keys.ctypes.data, ctypes.byref(centered)))
    keys = stick_keys[:max(status, 0)].copy()
    return status, value_indices, keys, bool(centered.value)


def inverse_map(indices: np.ndarray, num_slots: int,
                sentinel: int) -> Optional[np.ndarray]:
    """``out[indices[i]] = i`` (the last duplicate wins), ``sentinel``
    in every other of the ``num_slots`` slots, int32; raises
    ``IndexError`` where an index is outside ``[0, num_slots)``, as the
    numpy assignment does. None where the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    idx = np.asarray(indices).reshape(-1)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= num_slots):
        raise IndexError(
            f"inverse map index out of range [0, {num_slots})")
    idx = np.ascontiguousarray(idx, np.int32)
    out = np.empty(num_slots, np.int32)
    status = lib.spfft_tpu_inverse_map(idx.ctypes.data, idx.shape[0],
                                       out.ctypes.data, num_slots,
                                       ctypes.c_int32(sentinel))
    if status != 0:
        raise IndexError(
            f"inverse map index out of range [0, {num_slots})")
    return out
