"""Python side of the port's C ABI (``include/spfft_tpu_torch.h``,
``native/capi.cpp``): the counterpart of ``spfft_tpu/capi_bridge.py``.

Every function here is called from the embedded interpreter inside
``libspfft_tpu_torch.so`` with plain integers (addresses, sizes, enum
values) and returns ``(error_code, payload)``: exceptions never cross the
C boundary (the reference's try/catch -> code pattern,
src/spfft/grid.cpp:88-103). A refused call prints the port's message
(its traceback) on stderr.

Caller memory is host memory. Each call wraps the caller's buffer as a
tensor (``torch.from_numpy`` over a ``ctypes`` view, no copy), moves it to
the plan's device in one copy, runs the port's plan there, and copies the
result back in one ``copy_`` straight into the caller's buffer. Layout
changes happen on the device before that copy: the planar ``(2, N)``
values of a large local plan (``pair_values_io``) are put back in
interleaved order, and a distributed plan's padded per-shard blocks are
cut and concatenated into the C layout (per-shard values in shard order,
the full cube in global z order).

The device comes from ``SPFFT_TPU_TORCH_DEVICE``, read at plan creation:
unset (or empty) or ``cuda`` the current CUDA device, where no CUDA
device makes the plan refuse with ``DeviceError`` (code 13); ``cpu`` the
kernels' plain PyTorch versions on the host; anything else
``InvalidParameterError``.

``SpfftTpuPallasMode`` names the JAX package's Pallas compression kernels.
Here ``AUTO`` and ``ON`` take the fused route (the fused compression +
z-FFT CUDA kernels; a z axis above 512, which they decline, the
two-kernel route, and ``plan_info`` item 13 reads 0) and ``OFF`` the
two-kernel route (``fused=False``: the gather kernel and ``pdft_last``).
A distributed plan takes every exchange type (codes 0-5); its
``overlap_chunks`` and wire rung come from the environment variables the
JAX package reads (``SPFFT_TPU_OVERLAP_CHUNKS``,
``SPFFT_TPU_WIRE_PRECISION``, ``SPFFT_TPU_WIRE_ERROR_BUDGET``).

Batches (``multi_*``): the same handle for every transform runs as one
batched execution where ``multi.fusion_eligible`` admits it (local and
distributed plans, each by its own limit). Every transform of a batch is
queued on the device before the first result is copied back.

The handle table is module state: the C ABI's handles are process-wide.
Calls may come from any thread and run one at a time (``_call_lock``):
the GIL alone would not serialise them, since torch releases it inside
its device calls and copies.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import threading
import traceback
from typing import Dict, Tuple

import numpy as np
import torch

from .errors import (DeviceError, ErrorCode, GenericError,
                     InvalidParameterError)
from .multi import fusion_eligible
from .parallel import (DistributedTransformPlan, make_distributed_plan,
                       make_mesh)
from .plan import make_local_plan
from .types import ExchangeType, Scaling, TransformType
from .utils.dtypes import real_dtype

#: the environment variable that picks a plan's device
DEVICE_ENV = "SPFFT_TPU_TORCH_DEVICE"

_call_lock = threading.Lock()
_plans: Dict[int, object] = {}  #: guarded by _call_lock
_next_id = itertools.count(1)


class _InvalidHandle(GenericError):
    code = ErrorCode.INVALID_HANDLE


def _guarded(fn):
    def wrapper(*args) -> Tuple[int, int]:
        try:
            with _call_lock:
                payload = fn(*args)
        except Exception as exc:  # noqa: BLE001 — the C boundary
            traceback.print_exc()
            code = exc.error_code() if isinstance(exc, GenericError) \
                else ErrorCode.UNKNOWN
            return int(code), 0
        return int(ErrorCode.SUCCESS), 0 if payload is None else int(payload)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


#: C ABI <-> ExchangeType, in the reference's enum order (types.h:33-62)
_EXCHANGE_BY_INT = dict(enumerate((
    ExchangeType.DEFAULT, ExchangeType.BUFFERED,
    ExchangeType.BUFFERED_FLOAT, ExchangeType.COMPACT_BUFFERED,
    ExchangeType.COMPACT_BUFFERED_FLOAT, ExchangeType.UNBUFFERED)))
_INT_BY_EXCHANGE = {v: k for k, v in _EXCHANGE_BY_INT.items()}


def plan_device():
    """The device of a new plan, from :data:`DEVICE_ENV`: None (the
    current CUDA device) when unset, empty or ``cuda``, where
    :class:`~spfft_tpu_torch.errors.DeviceError` without one;
    ``"cpu"`` for ``cpu``."""
    name = os.environ.get(DEVICE_ENV, "")
    if name in ("", "cuda"):
        if not torch.cuda.is_available():
            raise DeviceError(
                f"no CUDA device: the C ABI of spfft_tpu_torch runs on the "
                f"GPU; set {DEVICE_ENV}=cpu to run the plain PyTorch "
                f"versions on the host")
        return None
    if name == "cpu":
        return "cpu"
    raise InvalidParameterError(
        f"{DEVICE_ENV} must be 'cuda' or 'cpu', got {name!r}")


def _create_args(transform_type: int, precision: int, use_pallas: int):
    """The enums of a plan creation -> (TransformType, precision name,
    fused)."""
    if transform_type not in (0, 1):
        raise InvalidParameterError(f"bad transform type {transform_type}")
    if precision not in (0, 1):
        raise InvalidParameterError(f"bad precision {precision}")
    if use_pallas not in (-1, 0, 1):
        raise InvalidParameterError(f"bad pallas mode {use_pallas}")
    return ((TransformType.C2C, TransformType.R2C)[transform_type],
            ("single", "double")[precision], use_pallas != 0)


def _scaling(scaling: int) -> Scaling:
    if scaling not in (0, 1):
        raise InvalidParameterError(f"bad scaling {scaling}")
    return Scaling.FULL if scaling == 1 else Scaling.NONE


def _array(addr: int, n: int, ctype) -> np.ndarray:
    """n elements of caller memory at ``addr`` (no copy)."""
    if n == 0:
        return np.empty(0, np.dtype(ctype))
    return np.ctypeslib.as_array(ctypes.cast(addr, ctypes.POINTER(ctype)),
                                 shape=(n,))


def _host(plan, addr: int, shape: tuple) -> torch.Tensor:
    """Caller memory at ``addr`` as a tensor of ``shape`` in the plan's
    real type (no copy)."""
    ctype = np.ctypeslib.as_ctypes_type(real_dtype(plan.precision))
    return torch.from_numpy(_array(addr, int(np.prod(shape)), ctype)
                            .reshape(shape))


def _register(plan) -> int:
    pid = next(_next_id)
    _plans[pid] = plan
    return pid


def _get_plan(pid: int):
    plan = _plans.get(pid)
    if plan is None:
        raise _InvalidHandle(f"no plan with handle {pid}")
    return plan


def _is_dist(plan) -> bool:
    return isinstance(plan, DistributedTransformPlan)


@_guarded
def plan_create(transform_type: int, dim_x: int, dim_y: int, dim_z: int,
                num_values: int, triplets_addr: int, precision: int,
                use_pallas: int) -> int:
    """A local plan (``make_local_plan``) on :func:`plan_device`."""
    kind, prec, fused = _create_args(transform_type, precision, use_pallas)
    if num_values < 0:
        raise InvalidParameterError(f"negative num_values {num_values}")
    trip = _array(triplets_addr, 3 * num_values,
                  ctypes.c_int32).reshape(num_values, 3).copy()
    return _register(make_local_plan(kind, dim_x, dim_y, dim_z, trip,
                                     precision=prec, device=plan_device(),
                                     fused=fused))


@_guarded
def plan_create_distributed(transform_type: int, dim_x: int, dim_y: int,
                            dim_z: int, num_shards: int, vps_addr: int,
                            triplets_addr: int, pps_addr: int,
                            precision: int, exchange_type: int,
                            use_pallas: int) -> int:
    """A distributed plan over ``num_shards`` shards held on the one
    device of :func:`plan_device` (``make_distributed_plan`` on
    ``make_mesh(num_shards)``)."""
    kind, prec, fused = _create_args(transform_type, precision, use_pallas)
    if exchange_type not in _EXCHANGE_BY_INT:
        raise InvalidParameterError(f"bad exchange type {exchange_type}")
    if num_shards < 1:
        raise InvalidParameterError(f"num_shards must be >= 1, got "
                                    f"{num_shards}")
    vps = _array(vps_addr, num_shards, ctypes.c_longlong).astype(np.int64)
    pps = _array(pps_addr, num_shards, ctypes.c_int32).astype(np.int64)
    if (vps < 0).any():
        raise InvalidParameterError("negative per-shard value count")
    total = int(vps.sum())
    trip = _array(triplets_addr, 3 * total,
                  ctypes.c_int32).reshape(total, 3).copy()
    offsets = np.concatenate([[0], np.cumsum(vps)])
    per_shard = [trip[offsets[r]:offsets[r + 1]] for r in range(num_shards)]
    return _register(make_distributed_plan(
        kind, dim_x, dim_y, dim_z, per_shard, [int(p) for p in pps],
        mesh=make_mesh(num_shards, plan_device()), precision=prec,
        exchange=_EXCHANGE_BY_INT[exchange_type], fused=fused))


@_guarded
def plan_destroy(pid: int) -> None:
    if _plans.pop(pid, None) is None:
        raise _InvalidHandle(f"no plan with handle {pid}")


# -- the C layouts <-> the plans' device layouts ------------------------------

def _space_shape(plan) -> tuple:
    """The C layout of a plan's space: the full cube, interleaved for
    C2C."""
    shape = (plan.dim_z, plan.dim_y, plan.dim_x)
    return shape if plan.transform_type is TransformType.R2C else shape + (2,)


def _pad_shards(flat: torch.Tensor, counts, rows: int):
    """Concatenated per-shard rows (``counts[r]`` each, in shard order) ->
    the padded ``(S, rows, ...)`` stack a distributed plan takes."""
    out = torch.zeros((len(counts), rows) + tuple(flat.shape[1:]),
                      dtype=flat.dtype, device=flat.device)
    off = 0
    for r, n in enumerate(counts):
        out[r, :n] = flat[off:off + n]
        off += n
    return out


def _cut_shards(padded: torch.Tensor, counts) -> torch.Tensor:
    """The inverse of :func:`_pad_shards`: each shard's first
    ``counts[r]`` rows, concatenated (contiguous)."""
    return torch.cat([padded[r, :n] for r, n in enumerate(counts)])


def _values_in(plan, addr: int) -> torch.Tensor:
    """The caller's values on the plan's device: ``(N, 2)`` for a local
    plan (which puts a pair-layout plan's planar order itself), the
    padded ``(S, max_values, 2)`` for a distributed one."""
    n = plan.num_global_elements
    t = _host(plan, addr, (n, 2)).to(plan.device)
    if not _is_dist(plan):
        return t
    dp = plan.dist_plan
    return _pad_shards(t, [p.num_values for p in dp.shard_plans],
                       dp.max_values)


def _values_out(plan, out: torch.Tensor) -> torch.Tensor:
    """A plan's values result -> the C layout ``(N, 2)`` on the device."""
    if _is_dist(plan):
        return _cut_shards(out, [p.num_values
                                 for p in plan.dist_plan.shard_plans])
    return out.t().contiguous() if plan.pair_values_io else out


def _space_in(plan, addr: int) -> torch.Tensor:
    """The caller's cube on the plan's device, padded into shard slabs
    for a distributed plan."""
    t = _host(plan, addr, _space_shape(plan)).to(plan.device)
    if not _is_dist(plan):
        return t
    dp = plan.dist_plan
    return _pad_shards(t, dp.num_planes, dp.max_planes)


def _space_out(plan, out: torch.Tensor) -> torch.Tensor:
    """A plan's space result -> the C layout (the full cube) on the
    device."""
    return _cut_shards(out, plan.dist_plan.num_planes) if _is_dist(plan) \
        else out


def _write(plan, addr: int, result: torch.Tensor) -> None:
    """One copy of ``result`` (in the C layout) into caller memory."""
    _host(plan, addr, tuple(result.shape)).copy_(result)


# -- transforms ---------------------------------------------------------------

def _backward(plan, values_addr: int) -> torch.Tensor:
    return _space_out(plan, plan.backward(_values_in(plan, values_addr)))


def _forward(plan, space_addr: int, scaling: Scaling) -> torch.Tensor:
    return _values_out(plan, plan.forward(_space_in(plan, space_addr),
                                          scaling))


@_guarded
def backward(pid: int, values_addr: int, space_addr: int) -> None:
    plan = _get_plan(pid)
    _write(plan, space_addr, _backward(plan, values_addr))


@_guarded
def forward(pid: int, space_addr: int, scaling: int,
            values_addr: int) -> None:
    plan = _get_plan(pid)
    _write(plan, values_addr, _forward(plan, space_addr, _scaling(scaling)))


@_guarded
def execute_pair(pid: int, values_in_addr: int, scaling: int,
                 values_out_addr: int) -> None:
    """backward then forward through the plan's ``apply_pointwise``, the
    space domain kept on the device. In place (out == in) is allowed: the
    input is on the device before the output is written."""
    plan = _get_plan(pid)
    sc = _scaling(scaling)
    out = plan.apply_pointwise(_values_in(plan, values_in_addr), scaling=sc)
    _write(plan, values_out_addr, _values_out(plan, out))


def _read_addr_array(addr: int, n: int) -> list:
    """n pointer-sized entries of a caller array (plan handles or buffer
    addresses)."""
    ptr = ctypes.cast(addr, ctypes.POINTER(ctypes.c_void_p))
    return [int(ptr[i] or 0) for i in range(n)]


def _batch(n: int, plans_addr: int):
    """The plans of a batch, and the one plan of a batch that runs as one
    batched execution (the same local handle throughout, admitted by
    ``multi.fusion_eligible``), else None."""
    handles = _read_addr_array(plans_addr, n)
    plans = [_get_plan(h) for h in handles]
    shared = plans[0] if len(set(handles)) == 1 \
        and fusion_eligible(plans[0], n) else None
    return plans, shared


def _stack_in(plan, addrs: list, shape: tuple) -> torch.Tensor:
    """B caller buffers of ``shape`` -> one ``(B,) + shape`` tensor on the
    plan's device, one copy per buffer."""
    out = torch.empty((len(addrs),) + shape, dtype=plan.real_dtype,
                      device=plan.device)
    for b, a in enumerate(addrs):
        out[b].copy_(_host(plan, a, shape))
    return out


@_guarded
def multi_backward(n: int, plans_addr: int, values_addr: int,
                   spaces_addr: int) -> None:
    """Batched backward over n transforms (reference:
    spfft_multi_transform_backward, multi_transform.h:37-54)."""
    plans, shared = _batch(n, plans_addr)
    vaddrs = _read_addr_array(values_addr, n)
    saddrs = _read_addr_array(spaces_addr, n)
    if shared is not None and _is_dist(shared):
        v = torch.stack([_values_in(shared, a) for a in vaddrs], dim=1)
        outs = [_space_out(shared, o)
                for o in shared.backward_batched(v).unbind(1)]
    elif shared is not None:
        v = _stack_in(shared, vaddrs, (shared.num_global_elements, 2))
        if shared.pair_values_io:
            v = v.transpose(1, 2)
        outs = list(shared.backward_batched(v).unbind(0))
    else:
        outs = [_backward(p, a) for p, a in zip(plans, vaddrs)]
    for p, a, out in zip(plans, saddrs, outs):
        _write(p, a, out)


@_guarded
def multi_forward(n: int, plans_addr: int, spaces_addr: int, scaling: int,
                  values_addr: int) -> None:
    """Batched forward over n transforms (reference:
    spfft_multi_transform_forward, multi_transform.h:56-72)."""
    sc = _scaling(scaling)
    plans, shared = _batch(n, plans_addr)
    saddrs = _read_addr_array(spaces_addr, n)
    vaddrs = _read_addr_array(values_addr, n)
    if shared is not None and _is_dist(shared):
        sp_ = torch.stack([_space_in(shared, a) for a in saddrs], dim=1)
        outs = [_values_out(shared, o)
                for o in shared.forward_batched(sp_, sc).unbind(1)]
    elif shared is not None:
        out = shared.forward_batched(
            _stack_in(shared, saddrs, _space_shape(shared)), sc)
        if shared.pair_values_io:
            out = out.transpose(1, 2).contiguous()
        outs = list(out.unbind(0))
    else:
        outs = [_forward(p, a, sc) for p, a in zip(plans, saddrs)]
    for p, a, out in zip(plans, vaddrs, outs):
        _write(p, a, out)


# -- getters ------------------------------------------------------------------

@_guarded
def plan_info(pid: int, what: int, shard: int = 0) -> int:
    """The getter ``what`` of the C ABI (0 dim_x, 1 dim_y, 2 dim_z, 3
    num_values, 4 transform type, 5 num_shards, 6 global_size, 7
    num_global_elements, 8-11 shard ``shard``'s local_z_offset,
    local_z_length, local_slice_size and num_local_elements, 12 exchange
    type, 13 whether the fused kernels run)."""
    plan = _get_plan(pid)
    dist = _is_dist(plan)
    base = {0: plan.dim_x, 1: plan.dim_y, 2: plan.dim_z,
            3: plan.num_global_elements,
            4: 0 if plan.transform_type is TransformType.C2C else 1,
            5: plan.dist_plan.num_shards if dist else 1,
            6: plan.global_size, 7: plan.num_global_elements,
            12: _INT_BY_EXCHANGE[plan.exchange if dist
                                 else ExchangeType.DEFAULT],
            13: int(plan.fused_dist_active if dist else plan.fused_active)}
    if what in base:
        return base[what]
    if what not in (8, 9, 10, 11):
        raise InvalidParameterError(f"bad plan_info query {what}")
    num_shards = base[5]
    if not 0 <= shard < num_shards:
        raise InvalidParameterError(
            f"shard {shard} out of range [0, {num_shards})")
    if dist:
        return {8: plan.local_z_offset, 9: plan.local_z_length,
                10: plan.local_slice_size,
                11: plan.num_local_elements}[what](shard)
    return {8: plan.local_z_offset, 9: plan.local_z_length,
            10: plan.local_slice_size, 11: plan.num_local_elements}[what]
