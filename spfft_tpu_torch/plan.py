"""Local (single-device) sparse 3D FFT plans: the port of
``spfft_tpu/plan.py``'s C2C and R2C paths, in single and double
precision.

Pipeline (reference: src/execution/execution_host.cpp:249-352; the JAX
package's matmul-DFT "T layout" path):

  backward:  decompress + z-DFT (one kernel) -> sticks_to_grid into the
             transposed plane grid (z, x, y) -> y-DFT, swap, x-DFT (the
             xy kernel) -> (z, y, x)
  forward:   x-DFT, swap, y-DFT (the xy kernel) -> grid_to_sticks ->
             z-DFT + compress (one kernel), FULL scaling folded into the
             z matrix

``fused=False`` asks for the two-kernel route instead (the JAX package's
``_decompress_planar`` -> ``_backward_rest_tp`` and ``_forward_head_tp``
-> ``_compress_planar``, what it runs where its fused kernels decline or
``SPFFT_TPU_FUSED_COMPRESS=0``): the z stage splits into a gather kernel
(``ops.gather_kernel``) and a DFT kernel (``dft_kernel.pdft_last``), with
the R2C (0,0)-stick completion as tensor ops between them. Both routes
run every shape; the default stays fused.

Batched execution (``backward_batched`` / ``forward_batched``) runs B
transforms over one plan with one launch of each kernel per direction:
the z kernels' batched grids, and one xy call over ``B * dim_z`` planes.
``apply_pointwise`` / ``iterate_pointwise`` run the backward -> ``fn``
-> forward round trip on the planar space domain.

R2C (real space, the half spectrum x in [0, dim_x//2] in frequency):
values folded from x < 0 are conjugated at the boundary (``value_conj``);
the decompress kernel completes the (x=0, y=0) stick before its z-DFT;
the x = 0 row of the plane grid is completed along y; the backward xy
kernel ends in the real inverse x-DFT (``pdft2_cr``) and the forward one
starts with the real x-DFT (``prdft2``). Real slabs go in and out.

A plan holds its tables on one device: CUDA unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version. With no ``device`` and no CUDA device the plan refuses to build
(:class:`~spfft_tpu_torch.errors.DeviceError`); it never carries on
quietly on the CPU.

Precision: ``precision="double"`` runs the whole pipeline in float64 —
values, sticks, planes, matrices and twiddle tables — through the
float64 instances of the same CUDA kernels (native FP64 on the card: no
double-single, no cast to float32 anywhere on the way), and returns
float64 results; ``"single"`` runs it in float32.

Long axes: every dims the JAX package plans is planned here. Each axis
takes its form by its length alone (``ops.dft.c2c_form`` /
``real_form``): above ``ops.dft.MATMUL_DFT_MAX`` the two-pass FFT,
Bluestein's FFT or ``torch.fft`` (``ops.dft_kernel``). The fused z
kernels hold a stick of at most 512: a longer z axis is declined
(``fused_fallback_reasons``, ``"dimz_over_cap"``) and the plan takes the
two-kernel route.

Not in this slice of the port, each raising a typed error that names
it: ``donate_inputs=True`` and the plan-artifact restore.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .errors import DeviceError, InvalidParameterError
from .indexing import (IndexPlan, build_index_plan, inverse_col_map,
                       occupied_x_window)
from .ops import dft, dft_kernel, fused_kernel, gather_kernel, stages
from .timing import timed_transform
from .types import Scaling, TransformType
from .utils.dtypes import as_interleaved, real_dtype, torch_real_dtype

#: Plans with at least this many values take and return value arrays in
#: the planar PAIR layout (2, N) — row 0 real, row 1 imaginary — instead
#: of interleaved rows (N, 2), as the JAX package does
#: (``spfft_tpu.plan.PAIR_IO_THRESHOLD``), so public layouts compare like
#: with like. 256^3 (8.8M values) stays interleaved; 320^3 and up switch.
PAIR_IO_THRESHOLD = 16_000_000


def predicted_rel_error(precision: str, max_dim: int,
                        mdft_covered: Optional[bool] = None,
                        device_double: bool = False) -> float:
    """Conservative predicted relative l2 error of a backward transform vs
    a dense f64 oracle, for values of bounded dynamic range — the JAX
    package's accuracy contract (``spfft_tpu.plan.predicted_rel_error``,
    docs/precision.md), which this package is held to: err ~ 2.8e-7 *
    (n/64)^0.13 in single precision, 5e-15 * (n/64)^0.13 in double. A
    double plan of this package runs native FP64 on the card, so its
    envelope is the native one (``device_double=False``, the default);
    ``device_double=True`` is the JAX package's double-single mode on a
    TPU, which this package does not have."""
    if mdft_covered is None:
        mdft_covered = dft.mdft_coverable((max_dim,))
    shape = (max(max_dim, 1) / 64.0) ** 0.13
    if precision == "single":
        base = 2.8e-7 * shape
        if not mdft_covered:
            base *= 4.0  # outside the calibrated matmul-DFT domain
        return base
    if device_double:
        return 2.0e-11 * shape
    return 5.0e-15 * shape


def resolve_device(device=None) -> torch.device:
    """The plan's device: the current CUDA device when ``device`` is
    None; raises :class:`~spfft_tpu_torch.errors.DeviceError` when CUDA
    is asked for (or implied) and absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device: spfft_tpu_torch runs on the GPU; pass "
                "device='cpu' to run the plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(f"device {device} requested but CUDA is not "
                              f"available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise InvalidParameterError(
            f"device must be 'cuda' or 'cpu', got {device}")
    return device


def _not_in_slice(what: str, later: str):
    return InvalidParameterError(
        f"{what} is not in this slice of spfft_tpu_torch; the {later} "
        f"slice adds it")


def _on_device(t: torch.Tensor) -> bool:
    """True for a tensor on an accelerator (not host memory)."""
    return isinstance(t, torch.Tensor) and t.device.type != "cpu"


class TransformPlan:
    """A sparse 3D FFT on a single device — a local reference
    ``Transform`` (reference: include/spfft/transform.hpp:56-227), C2C or
    R2C, in single or double ``precision`` (float32 or float64 through
    and through). ``fused=False`` takes the two-kernel route (the module
    docstring); ``donate_inputs=True`` raises, as it is not in this
    slice."""

    def __init__(self, index_plan: IndexPlan, precision: str = "single",
                 device=None, fused: bool = True,
                 donate_inputs: bool = False):
        p = index_plan
        real_dtype(precision)
        if donate_inputs:
            raise _not_in_slice("donate_inputs=True", "serving")
        self.index_plan = p
        self.precision = precision
        #: the torch real type of every tensor the plan computes on
        self.real_dtype = torch_real_dtype(precision)
        self.device = resolve_device(device)
        self._pair_io = p.num_values >= PAIR_IO_THRESHOLD
        self._r2c = p.hermitian
        why = fused_kernel.eligible_dim(p.dim_z)
        #: per direction, why a fused z kernel declined (JAX's keys)
        self._fused_reasons = {"dec": why, "cmp": why} \
            if fused and why is not None else {}
        self._fused = bool(fused) and why is None
        dev = self.device

        def idx32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        # backward gather map with one trailing stick of sentinels: the
        # decompress kernel writes that stick as zeros, and it is the
        # zero row the sentinel columns of sticks_to_grid_padded select
        self._slot_src = idx32(np.concatenate(
            [p.slot_src, np.full(p.dim_z, p.num_values, np.int32)]))
        if self._fused:
            self._csr = tuple(idx32(a) for a in fused_kernel.compress_csr(
                p.value_indices, p.num_sticks, p.dim_z))
        else:  # the compress gather reads each value's slot directly
            self._value_indices = idx32(p.value_indices)
        zid = p.zero_stick_id if self._r2c else None
        self._zero_stick = -1 if zid is None else zid
        self._conj = None
        if p.value_conj is not None and np.asarray(p.value_conj).any():
            # folded values are stored conjugated: ±1 on the imaginary
            # lane of backward input and forward output, exact in any type
            s = np.where(np.asarray(p.value_conj), -1.0, 1.0)
            m = np.stack([np.ones_like(s), s], axis=0 if self._pair_io else -1)
            self._conj = torch.as_tensor(m, dtype=self.real_dtype, device=dev)
        self._init_split_x()
        rdt = self.real_dtype

        def c2c(n, sign, **window):
            return dft.device_c2c(n, sign, device=dev, dtype=rdt, **window)

        gs = 1.0 / float(self.global_size)
        # the fused z kernels' form of dim_z (the matrix form where dim_z
        # has a prime of 13 or more), else the length's own
        zf = fused_kernel.z_mats_form(p.dim_z) if self._fused else None
        self._mats = {
            "z_b": c2c(p.dim_z, dft.BACKWARD, form=zf),
            "z_f": c2c(p.dim_z, dft.FORWARD, form=zf),
            "z_fs": c2c(p.dim_z, dft.FORWARD, scale=gs, form=zf),
            "y_b": c2c(p.dim_y, dft.BACKWARD),
            "y_f": c2c(p.dim_y, dft.FORWARD),
        }
        # the x matrices restricted to the window (without a split the
        # window is every frequency x, and the selection is the whole)
        x0, w = self._split_x or (0, p.dim_x_freq)
        if self._r2c:
            self._mats["x_b"] = dft.device_c2r(p.dim_x, rows=(x0, w),
                                               device=dev, dtype=rdt)
            self._mats["x_f"] = dft.device_r2c(p.dim_x, cols=(x0, w),
                                               device=dev, dtype=rdt)
        else:
            self._mats["x_b"] = c2c(p.dim_x, dft.BACKWARD, rows=(x0, w))
            self._mats["x_f"] = c2c(p.dim_x, dft.FORWARD, cols=(x0, w))
        # plane symmetry applies to the x = 0 sub-column when the window
        # starts at 0; otherwise no x = 0 stick exists
        self._complete_x0 = self._r2c and x0 == 0

    def _init_split_x(self) -> None:
        """Run the xy stage on the occupied x window only when it spans
        at most 70% of the frequency x extent (the reference's "y
        transform over non-empty x-rows only", execution_host.cpp:139-145).
        For C2C the window is cyclic: centered sets store negative x
        high, so their window wraps. For R2C it is a linear window of the
        half spectrum. Sets the stick <-> transposed-plane column
        tables."""
        p = self.index_plan
        self._split_x = None
        xf = p.dim_x_freq
        x_w, width = p.stick_x.astype(np.int64), xf
        if p.num_sticks:
            x0, w = occupied_x_window(p.stick_x, xf,
                                      allow_wrap=not self._r2c)
            if w <= 0.7 * xf:
                self._split_x = (x0, w)
                x_w, width = (x_w - x0) % xf, w
        cols = x_w * p.dim_y + p.stick_y.astype(np.int64)
        self._grid_w = width
        self._scatter_cols = torch.as_tensor(cols, device=self.device)
        self._col_inv = torch.as_tensor(
            inverse_col_map(cols, width * p.dim_y, p.num_sticks)
            .astype(np.int64), device=self.device)

    # -- reference Transform getters (transform.hpp:91-151) -----------------
    @property
    def transform_type(self) -> TransformType:
        return self.index_plan.transform_type

    @property
    def dim_x(self) -> int:
        return self.index_plan.dim_x

    @property
    def dim_y(self) -> int:
        return self.index_plan.dim_y

    @property
    def dim_z(self) -> int:
        return self.index_plan.dim_z

    @property
    def local_z_length(self) -> int:
        return self.index_plan.dim_z

    @property
    def local_z_offset(self) -> int:
        return 0

    @property
    def local_slice_size(self) -> int:
        return self.dim_x * self.dim_y * self.local_z_length

    @property
    def num_local_elements(self) -> int:
        return self.index_plan.num_values

    @property
    def num_global_elements(self) -> int:
        return self.index_plan.num_values

    @property
    def global_size(self) -> int:
        return self.dim_x * self.dim_y * self.dim_z

    @property
    def pair_values_io(self) -> bool:
        """True when value arrays use the planar pair layout
        ``(2, num_values)`` (see :data:`PAIR_IO_THRESHOLD`): ``backward``
        accepts both layouts, ``forward`` returns the pair."""
        return self._pair_io

    @property
    def split_x(self):
        """The occupied x window ``(x0, w)`` the xy stage runs on, or
        None for the full x extent."""
        return self._split_x

    @property
    def fused_active(self) -> bool:
        """True when both directions run the fused compression + z-DFT
        kernels (``ops.fused_kernel``); False on the two-kernel route
        (``fused=False``, or a z axis the fused kernels decline)."""
        return self._fused

    @property
    def fused_fallback_reasons(self) -> dict:
        """Per-direction reasons a fused kernel declined, as in the JAX
        package (``{"dec": reason, "cmp": reason}``): ``"dimz_over_cap"``
        for both where ``fused=True`` was asked for and dim_z exceeds
        ``ops.fused_kernel.MAX_DIM_Z``; ``{}`` where the fused kernels run
        or the two-kernel route was the caller's choice."""
        return dict(self._fused_reasons)

    @property
    def predicted_error(self) -> float:
        """:func:`predicted_rel_error` of this plan: its precision, its
        longest axis, and whether the JAX package's matrix forms cover its
        axes (``ops.dft.mdft_coverable``, a hermitian x axis direct only);
        where they do not, the ``torch.fft`` form runs and the model's
        uncalibrated factor applies."""
        p = self.index_plan
        dims = (p.dim_x, p.dim_y, p.dim_z)
        return predicted_rel_error(self.precision, max(dims),
                                   dft.mdft_coverable(dims, p.hermitian))

    # -- the pipeline, on planar operands with an optional leading batch ----
    def _bwd_space(self, v: torch.Tensor):
        """Values in the plan's layout, ``(B?, N, 2)`` or ``(B?, 2, N)``,
        -> planar space: ``(xr, xi)`` each ``(B?, dim_z, dim_y, dim_x)``
        for C2C, the real slab for R2C (the JAX package's
        ``_bwd_space_tp``)."""
        p = self.index_plan
        if self._conj is not None:
            v = v * self._conj
        if self._fused:
            sr, si = fused_kernel.decompress_zdft(
                v, self._slot_src, self._mats["z_b"], p.dim_z,
                self._pair_io, self._zero_stick)
        else:
            sr, si = gather_kernel.decompress(v, self._slot_src, p.dim_z,
                                              self._pair_io)
            zid = self._zero_stick
            if zid >= 0:  # in place: the sticks are this call's own
                sr[..., zid, :], si[..., zid, :] = \
                    stages.complete_stick_hermitian(sr[..., zid, :],
                                                    si[..., zid, :])
            sr, si = dft_kernel.pdft_last(sr, si, self._mats["z_b"])
        return self._backward_after_z(sr, si)

    def _backward_after_z(self, sr, si):
        """z-transformed sticks ``(B?, S + 1, dim_z)`` (the last one the
        zero sentinel stick) -> planar space: placement into the
        transposed plane grid, then one xy call over every plane of the
        batch."""
        p = self.index_plan
        lead = tuple(sr.shape[:-2])
        gr = stages.sticks_to_grid_padded(sr, self._col_inv, self._grid_w,
                                          p.dim_y)
        gi = stages.sticks_to_grid_padded(si, self._col_inv, self._grid_w,
                                          p.dim_y)
        planes = (-1, self._grid_w, p.dim_y)
        gr, gi = gr.view(planes), gi.view(planes)
        if self._r2c:
            if self._complete_x0:
                stages.complete_plane_hermitian_t(gr, gi)
            out = dft_kernel.pdft2_cr(gr, gi, self._mats["y_b"],
                                      self._mats["x_b"])
            return out.reshape(lead + (p.dim_z, p.dim_y, p.dim_x))
        xr, xi = dft_kernel.pdft2(gr, gi, self._mats["y_b"],
                                  self._mats["x_b"])
        shape = lead + (p.dim_z, p.dim_y, p.dim_x)
        return xr.reshape(shape), xi.reshape(shape)

    def _fwd_values(self, space, scaled: bool) -> torch.Tensor:
        """Planar space (as :meth:`_bwd_space` returns it; contiguous)
        -> values in the plan's layout (the JAX package's
        ``_fwd_values_tp``), FULL scaling folded into the z matrix."""
        p = self.index_plan
        planes = (-1, p.dim_y, p.dim_x)
        if self._r2c:
            lead = tuple(space.shape[:-3])
            gr, gi = dft_kernel.prdft2(space.reshape(planes),
                                       self._mats["x_f"], self._mats["y_f"])
        else:
            lead = tuple(space[0].shape[:-3])
            gr, gi = dft_kernel.pdft2(space[0].reshape(planes),
                                      space[1].reshape(planes),
                                      self._mats["x_f"], self._mats["y_f"])
        grid = lead + (p.dim_z, self._grid_w, p.dim_y)
        sr = stages.grid_to_sticks(gr.reshape(grid), self._scatter_cols)
        si = stages.grid_to_sticks(gi.reshape(grid), self._scatter_cols)
        z = self._mats["z_fs" if scaled else "z_f"]
        if self._fused:
            out = fused_kernel.zdft_compress(sr, si, z, self._csr,
                                             self._pair_io)
        else:
            yr, yi = dft_kernel.pdft_last(sr, si, z)
            out = gather_kernel.compress(yr, yi, self._value_indices,
                                         self._pair_io)
        return out if self._conj is None else out.mul_(self._conj)

    def _public_space(self, space) -> torch.Tensor:
        """Planar space -> the public layout: interleaved ``(..., 2)``
        for C2C, the real slab as it is for R2C."""
        return space if self._r2c else torch.stack(space, dim=-1)

    def _planar_space(self, space: torch.Tensor):
        """A coerced public space slab (or batch of slabs) -> the planar
        operands of :meth:`_fwd_values`."""
        if self._r2c:
            return space
        return space[..., 0].contiguous(), space[..., 1].contiguous()

    # -- execution (reference: transform.hpp:198-211) -------------------------
    def backward(self, values) -> torch.Tensor:
        """Frequency -> space. ``values`` is ``(num_values,)`` complex or
        ``(num_values, 2)`` interleaved (or ``(2, num_values)`` for
        pair-layout plans), a tensor or a numpy array. Returns the
        unnormalised inverse DFT (details.rst "Transform Definition") on
        the plan's device, in the plan's real type (float32, or float64
        for a double plan): the ``(dim_z, dim_y, dim_x, 2)`` slab for
        C2C, the real ``(dim_z, dim_y, dim_x)`` slab for R2C."""
        v = self._coerce_values(values)
        with timed_transform("backward") as box:
            box.value = self._public_space(self._bwd_space(v))
        return box.value

    def forward(self, space, scaling: Scaling = Scaling.NONE) -> torch.Tensor:
        """Space -> frequency. ``space`` is the ``(dim_z, dim_y, dim_x)``
        slab: complex or ``(..., 2)`` interleaved for C2C, real for R2C
        (a complex slab is refused). Returns ``(num_values, 2)`` values
        of the plan's real type — ``(2, num_values)`` for pair-layout
        plans;
        ``Scaling.FULL`` multiplies by 1/(Nx·Ny·Nz) (details.rst
        "Normalization"), folded into the z matrix."""
        scaling = Scaling(scaling)
        sp = self._planar_space(self._coerce_space(space))
        with timed_transform("forward") as box:
            box.value = self._fwd_values(sp, scaling is Scaling.FULL)
        return box.value

    # -- batched execution -----------------------------------------------------
    def batch_row_template(self, kind: str):
        """``(shape, dtype)`` of one coerced host row of a batched
        execution: ``kind`` ``"values"`` (backward input) or ``"space"``
        (forward input). A host buffer ``(B,) + shape`` of this numpy
        dtype, filled row by row, is taken by :meth:`backward_batched` /
        :meth:`forward_batched` as it is, in one transfer."""
        p = self.index_plan
        rdt = real_dtype(self.precision)
        if kind == "values":
            return gather_kernel.values_shape(None, p.num_values,
                                              self._pair_io), rdt
        if kind != "space":
            raise InvalidParameterError(
                f"kind must be 'values' or 'space', got {kind!r}")
        shape3 = (self.local_z_length, p.dim_y, p.dim_x)
        return (shape3 if self._r2c else shape3 + (2,)), rdt

    def _prestaged(self, batch, per) -> bool:
        """True for a host array already in the coerced batched layout
        ``(B,) + per`` at the plan's exact real dtype."""
        return (isinstance(batch, np.ndarray) and batch.ndim == len(per) + 1
                and batch.shape[1:] == per
                and batch.dtype == real_dtype(self.precision))

    def _stack_coerced(self, items, coerce) -> torch.Tensor:
        """Stack per-transform inputs into one batch on the plan's
        device. Rows that are not on a device yet are coerced and
        stacked on the host and moved in ONE transfer (B separate copies
        to the card, then a device concatenation, would cost more)."""
        items = list(items)
        if not items:
            raise InvalidParameterError("a batch needs at least one row")
        if any(_on_device(v) for v in items):
            return torch.stack([coerce(v) for v in items])
        host = torch.device("cpu")
        return torch.stack([coerce(v, host) for v in items]).to(self.device)

    def _batch_tensor(self, batch, per) -> Optional[torch.Tensor]:
        """A tensor or prestaged array already shaped ``(B,) + per`` ->
        a contiguous tensor of the plan's real type on its device; None
        otherwise."""
        if isinstance(batch, torch.Tensor) and batch.dim() == len(per) + 1 \
                and tuple(batch.shape[1:]) == per and not batch.is_complex():
            return batch.to(self.device, self.real_dtype).contiguous()
        if self._prestaged(batch, per):  # copied, as _coerce_values does
            return torch.tensor(batch, device=self.device)
        return None

    def backward_batched(self, values_batch) -> torch.Tensor:
        """Backward-execute a batch over this plan: ``values_batch`` is a
        ``(B,) + row`` tensor or array in the plan's value layout
        (:meth:`batch_row_template`), or a sequence of per-transform
        values in any form :meth:`backward` takes. Returns the ``(B,
        ...)`` space slabs, each band equal to :meth:`backward` of its
        row, with one launch of each kernel whatever B is."""
        per = self.batch_row_template("values")[0]
        v = self._batch_tensor(values_batch, per)
        if v is None:
            v = self._stack_coerced(values_batch, self._coerce_values)
        with timed_transform("backward_batched") as box:
            box.value = self._public_space(self._bwd_space(v))
        return box.value

    def forward_batched(self, space_batch,
                        scaling: Scaling = Scaling.NONE) -> torch.Tensor:
        """Forward-execute a batch of space slabs (a ``(B,) + slab``
        tensor or array, or a sequence of slabs in any form
        :meth:`forward` takes). Returns ``(B, num_values, 2)`` values —
        ``(B, 2, num_values)`` for pair-layout plans."""
        scaling = Scaling(scaling)
        per = self.batch_row_template("space")[0]
        sp = self._batch_tensor(space_batch, per)
        if sp is None:
            sp = self._stack_coerced(space_batch, self._coerce_space)
        sp = self._planar_space(sp)
        with timed_transform("forward_batched") as box:
            box.value = self._fwd_values(sp, scaling is Scaling.FULL)
        return box.value

    # -- the round trip --------------------------------------------------------
    def _pair(self, v: torch.Tensor, fn, fn_args, scaled: bool):
        """backward -> ``fn(space, *fn_args)`` -> forward on coerced
        values. Without ``fn`` the planar space goes straight on; with
        it, ``fn`` sees the public layout and its result is checked as
        :meth:`forward` checks a slab."""
        space = self._bwd_space(v)
        if fn is not None:
            out = fn(self._public_space(space), *fn_args)
            space = self._planar_space(self._coerce_space(out))
        return self._fwd_values(space, scaled)

    def apply_pointwise(self, values, fn=None, *fn_args,
                        scaling: Scaling = Scaling.NONE) -> torch.Tensor:
        """backward -> ``fn(space, *fn_args)`` -> forward: the plane-wave
        inner loop of applying a local operator in the space domain.
        ``fn`` receives the space slab in its public layout, ``(dim_z,
        dim_y, dim_x, 2)`` for C2C, real ``(dim_z, dim_y, dim_x)`` for
        R2C, in the plan's real type on its device, and returns the same
        shape; data
        that changes between calls (a potential) goes through
        ``fn_args``. ``fn=None`` is the identity round trip, kept planar
        throughout. Returns the values in the plan's layout."""
        scaling = Scaling(scaling)
        v = self._coerce_values(values)
        with timed_transform("apply_pointwise") as box:
            box.value = self._pair(v, fn, fn_args, scaling is Scaling.FULL)
        return box.value

    def iterate_pointwise(self, values, fn, *fn_args, steps: int,
                          scaling: Scaling = Scaling.FULL) -> torch.Tensor:
        """``steps`` round trips values -> backward -> ``fn`` -> forward
        -> values, as :meth:`apply_pointwise` runs one. ``scaling``
        defaults to FULL so that the iteration is a fixed-point map.
        Returns the final values."""
        scaling = Scaling(scaling)
        if int(steps) < 0:
            raise InvalidParameterError(f"steps must be >= 0, got {steps}")
        v = self._coerce_values(values)
        with timed_transform("iterate_pointwise") as box:
            for _ in range(int(steps)):
                v = self._pair(v, fn, fn_args, scaling is Scaling.FULL)
            box.value = v
        return box.value

    # -- input coercion ------------------------------------------------------
    def _coerce_values(self, values, device=None) -> torch.Tensor:
        """Values -> contiguous tensor of the plan's real type on its
        device (or on ``device``) in the plan's layout: (N, 2), or (2, N)
        for pair-layout plans. A numpy input is copied (it may be
        read-only, or the caller's)."""
        n = self.index_plan.num_values
        device = self.device if device is None else device
        if isinstance(values, torch.Tensor):
            t = values.to(device)
            if t.is_complex():
                t = torch.view_as_real(t)
            t = t.to(self.real_dtype)
            if self._pair_io and tuple(t.shape) == (2, n):
                return t.contiguous()
            if tuple(t.shape) == (n, 2):
                return (t.t() if self._pair_io else t).contiguous()
            raise InvalidParameterError(
                f"expected {n} frequency values, got shape {tuple(t.shape)}")
        arr = np.asarray(values)
        if self._pair_io and arr.shape == (2, n) \
                and not np.iscomplexobj(arr):
            return torch.tensor(arr, dtype=self.real_dtype, device=device)
        arr = as_interleaved(arr, self.precision)
        if arr.shape != (n, 2):
            raise InvalidParameterError(
                f"expected {n} frequency values, got shape {arr.shape[:-1]}")
        t = torch.tensor(arr, device=device)
        return t.t().contiguous() if self._pair_io else t

    def _coerce_space(self, space, device=None) -> torch.Tensor:
        """Space slab -> contiguous tensor of the plan's real type on its
        device (or on ``device``): (dim_z, dim_y, dim_x, 2) for C2C, real
        (dim_z, dim_y, dim_x) for R2C. A numpy input is copied."""
        p = self.index_plan
        device = self.device if device is None else device
        shape3 = (self.local_z_length, p.dim_y, p.dim_x)
        if self._r2c:
            if isinstance(space, torch.Tensor):
                complex_in = space.is_complex()
            else:
                space = np.asarray(space)
                complex_in = np.iscomplexobj(space)
            if complex_in or tuple(space.shape) != shape3:
                raise InvalidParameterError(
                    f"expected real space-domain slab {shape3}, got "
                    f"{'complex ' if complex_in else ''}"
                    f"{tuple(space.shape)}")
            if isinstance(space, torch.Tensor):
                return space.to(device, self.real_dtype).contiguous()
            return torch.tensor(space, dtype=self.real_dtype, device=device)
        if isinstance(space, torch.Tensor):
            t = space.to(device)
            if t.is_complex():
                t = torch.view_as_real(t)
            t = t.to(self.real_dtype)
        else:
            t = torch.tensor(as_interleaved(space, self.precision),
                             device=device)
        if tuple(t.shape) != shape3 + (2,):
            raise InvalidParameterError(
                f"expected space-domain slab {shape3} complex, got "
                f"{tuple(t.shape)}")
        return t.contiguous()


def restore_plan(index_plan: IndexPlan, tables, precision: str = "single",
                 **plan_kwargs) -> TransformPlan:
    """The plan-artifact restore of the JAX package; not in this slice."""
    raise _not_in_slice("the plan-artifact restore", "serving")


def make_local_plan(transform_type: TransformType, dim_x: int, dim_y: int,
                    dim_z: int, triplets, precision: str = "single",
                    device=None, fused: bool = True,
                    donate_inputs: bool = False) -> TransformPlan:
    """Build a local plan from raw index triplets (reference:
    grid.hpp:138-141). The plan runs on ``device``: CUDA by default,
    ``"cpu"`` for the plain PyTorch versions. ``fused=False`` takes the
    two-kernel route (see the module docstring)."""
    plan = build_index_plan(TransformType(transform_type), dim_x, dim_y,
                            dim_z, np.asarray(triplets))
    return TransformPlan(plan, precision=precision, device=device,
                         fused=fused, donate_inputs=donate_inputs)
