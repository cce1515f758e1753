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

The plan surface the serving layer calls, as in the JAX package:
:meth:`TransformPlan.export_tables` / :func:`restore_plan` (a plan rebuilt
from its host tables, building none), :meth:`~TransformPlan.install_aot`
(this package has no serialised executables: an empty set is accepted,
anything else refused), :meth:`~TransformPlan.check_build` /
:meth:`~TransformPlan.close`, :meth:`~TransformPlan.estimated_device_bytes`,
``donate_inputs=True`` (the round trips write their result into the
values tensor they were given), ``device=`` on the four execution entries
and ``max_rel_error=`` (:class:`~spfft_tpu_torch.errors.PrecisionContractError`).

Faults and observability (:mod:`spfft_tpu_torch.faults`,
:mod:`spfft_tpu_torch.obs`): construction consults the ``plan.build``
seam twice — the first check raises from the constructor, the second
(the JAX package's background table build) is kept as a sticky
:class:`~spfft_tpu_torch.errors.TableBuildError` that every execution and
``check_build`` raise — records ``spfft_plan_builds_total`` and the
``compile.plan_build`` span, and records each fused decline under the JAX
package's stage names. At run time a fused z kernel that fails with an
error charged to the device (``faults.attributes_device``) demotes its
direction (``"dec"`` backward, ``"cmp"`` forward) to the two-kernel
route's kernels, which serve that call and the following ones; after
:attr:`~TransformPlan.FUSED_REPROBE_AFTER` calls one re-probe runs the
fused kernel again and readmits it on success, and after
:attr:`~TransformPlan.FUSED_REPROBE_MAX` failed probes the demotion is
permanent (``fused_demotions()``, ``spfft_fused_demotions_total``, a
``fused.demote`` event and a logged warning). A kernel that does not
build is never demoted: its error is not charged to the device.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from . import faults, obs
from .errors import (DeviceError, InvalidParameterError,
                     PrecisionContractError, TableBuildError)
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

logger = logging.getLogger("spfft_tpu_torch")

#: the JAX package's stage names of the fused declines, per direction
_FUSED_STAGES = {"dec": "fused_decompress_zdft", "cmp": "fused_zdft_compress"}


@dataclasses.dataclass(frozen=True)
class PlanTables:
    """Host snapshot of the tables a plan builds from its index plan — the
    restore payload of a plan artifact (the JAX package's ``PlanTables``,
    ``spfft_tpu/plan.py:59``, holding this package's tables).

    ``arrays`` maps each table's name to a host numpy array: ``slot_src``
    (the backward gather map with its sentinel stick), the forward CSR
    ``csr_ptr`` / ``csr_val`` / ``csr_z`` (fused route) or
    ``value_indices`` (two-kernel route), ``conj_sign`` (where values are
    stored conjugated), ``scatter_cols`` and ``col_inv`` (the stick <->
    transposed-plane maps). ``split_x`` is the xy stage's window (or
    None) and ``grid_w`` its width; ``fused`` is whether the tables are
    the fused route's; ``fused_reasons`` the per-direction declines. The
    DFT matrices and twiddle tables are functions of the lengths alone and
    are made anew at a restore."""

    arrays: dict
    split_x: Optional[tuple]
    grid_w: int
    fused: bool
    fused_reasons: dict


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


def _on_device(t: torch.Tensor) -> bool:
    """True for a tensor on an accelerator (not host memory)."""
    return isinstance(t, torch.Tensor) and t.device.type != "cpu"


class TransformPlan:
    """A sparse 3D FFT on a single device — a local reference
    ``Transform`` (reference: include/spfft/transform.hpp:56-227), C2C or
    R2C, in single or double ``precision`` (float32 or float64 through
    and through). ``fused=False`` takes the two-kernel route (the module
    docstring). ``donate_inputs=True`` lets :meth:`apply_pointwise` and
    :meth:`iterate_pointwise` write their result into the values tensor
    they were given (a tensor on the plan's device of its real type and
    layout; the caller's tensor then holds the result, as a donated JAX
    buffer is consumed), saving one values array at the round trip's
    peak; a numpy input, or one that needs converting, is unaffected.
    ``max_rel_error`` demands an accuracy contract at construction:
    where :attr:`predicted_error` exceeds it the plan raises
    :class:`~spfft_tpu_torch.errors.PrecisionContractError`."""

    #: Two-kernel calls a demoted direction serves before one fused
    #: re-probe, and how many failed probes make the demotion permanent
    #: (the JAX package's ``spfft_tpu/plan.py:777-778``).
    FUSED_REPROBE_AFTER = 32
    FUSED_REPROBE_MAX = 3

    def __init__(self, index_plan: IndexPlan, precision: str = "single",
                 device=None, fused: bool = True,
                 donate_inputs: bool = False,
                 max_rel_error: Optional[float] = None,
                 _restore: Optional[PlanTables] = None):
        t0 = time.perf_counter()
        p = index_plan
        real_dtype(precision)
        self.index_plan = p
        self.precision = precision
        #: the torch real type of every tensor the plan computes on
        self.real_dtype = torch_real_dtype(precision)
        self.device = resolve_device(device)
        self.donate_inputs = bool(donate_inputs)
        self._pair_io = p.num_values >= PAIR_IO_THRESHOLD
        self._r2c = p.hermitian
        if max_rel_error is not None:
            self._check_contract(float(max_rel_error))
        why = fused_kernel.eligible_dim(p.dim_z)
        if _restore is not None:
            if bool(_restore.fused) != (bool(fused) and why is None):
                raise InvalidParameterError(
                    f"restored tables are the "
                    f"{'fused' if _restore.fused else 'two-kernel'} "
                    f"route's, but this plan takes the other")
            #: per direction, why a fused z kernel declined (JAX's keys)
            self._fused_reasons = dict(_restore.fused_reasons or {})
        else:
            self._fused_reasons = {"dec": why, "cmp": why} \
                if fused and why is not None else {}
        self._fused = bool(fused) and why is None
        host = self._host_tables() if _restore is None \
            else self._check_restore(_restore)
        self._tabs = self._commit(host, self.device)
        self._mats = self._make_mats(self.device)
        # runtime fused-kernel demotion ladder, per direction ("dec" /
        # "cmp"): {"reason", "unfused_ok", "probes", "probing",
        # "permanent"}
        self._fused_demotions = {}
        #: the executables (JAX's jit cache keys) a fused kernel has run in
        self._seam_keys = fused_kernel.SeamKeys()
        #: tables and matrices copied to another CUDA device, per device
        self._device_tables = {}
        self._build_exc = None
        # the plan.build seam: the constructor's half raises, the table
        # build's half (a background thread in the JAX package) is sticky
        faults.check_site("plan.build")
        if _restore is None:
            try:
                faults.check_site("plan.build")
            except faults.InjectedFault as exc:
                self._build_exc = exc
            for which, reason in sorted(self._fused_reasons.items()):
                obs.record_plan_fallback(_FUSED_STAGES[which], reason)
        obs.record_plan_build(self, time.perf_counter() - t0, t0)

    def _check_contract(self, max_rel_error: float) -> None:
        predicted = self.predicted_error
        if predicted > max_rel_error:
            p = self.index_plan
            hint = ("no precision of this package reaches it"
                    if self.precision == "double" else
                    "precision='double' runs native FP64 on the card")
            raise PrecisionContractError(
                f"precision='{self.precision}' predicts relative error "
                f"~{predicted:.1e} at dims ({p.dim_x},{p.dim_y},{p.dim_z}), "
                f"above the requested max_rel_error={max_rel_error:.1e} — "
                f"{hint}")

    # -- tables --------------------------------------------------------------
    def _host_tables(self) -> PlanTables:
        """Build the plan's tables on the host from its index plan."""
        p = self.index_plan
        arrays = {"slot_src": np.concatenate(
            [p.slot_src, np.full(p.dim_z, p.num_values, np.int32)])
            .astype(np.int32)}
        # backward gather map with one trailing stick of sentinels: the
        # decompress kernel writes that stick as zeros, and it is the
        # zero row the sentinel columns of sticks_to_grid_padded select
        if self._fused:
            ptr, val, z = fused_kernel.compress_csr(
                p.value_indices, p.num_sticks, p.dim_z)
            arrays.update(csr_ptr=ptr, csr_val=val, csr_z=z)
        else:  # the compress gather reads each value's slot directly
            arrays["value_indices"] = np.asarray(p.value_indices, np.int32)
        if p.value_conj is not None and np.asarray(p.value_conj).any():
            # folded values are stored conjugated: ±1 on the imaginary
            # lane of backward input and forward output
            arrays["conj_sign"] = np.where(np.asarray(p.value_conj), -1,
                                           1).astype(np.int8)
        split, width, cols = self._split_tables()
        arrays["scatter_cols"] = cols
        arrays["col_inv"] = inverse_col_map(
            cols, width * p.dim_y, p.num_sticks).astype(np.int64)
        return PlanTables(arrays=arrays, split_x=split, grid_w=width,
                          fused=self._fused,
                          fused_reasons=dict(self._fused_reasons))

    def _split_tables(self):
        """Run the xy stage on the occupied x window only when it spans
        at most 70% of the frequency x extent (the reference's "y
        transform over non-empty x-rows only", execution_host.cpp:139-145).
        For C2C the window is cyclic: centered sets store negative x
        high, so their window wraps. For R2C it is a linear window of the
        half spectrum. Returns the window (or None), the grid's width and
        the stick -> transposed-plane column table."""
        p = self.index_plan
        split = None
        xf = p.dim_x_freq
        x_w, width = p.stick_x.astype(np.int64), xf
        if p.num_sticks:
            x0, w = occupied_x_window(p.stick_x, xf,
                                      allow_wrap=not self._r2c)
            if w <= 0.7 * xf:
                split = (int(x0), int(w))
                x_w, width = (x_w - x0) % xf, int(w)
        cols = x_w * p.dim_y + p.stick_y.astype(np.int64)
        return split, width, cols

    def _check_restore(self, r: PlanTables) -> PlanTables:
        """Refuse tables that do not fit this plan's index plan: each
        table's length, integer type and range, the CSR's row pointers
        and the xy window. The kernels do not check the indices they read
        (a gather, a scatter of values), so a restored table that is
        corrupt, truncated or of another plan is refused here, before it
        reaches the device. O(n) reductions on the host; no table is
        built."""
        p = self.index_plan
        a = r.arrays
        ns, nv, nz, xf = p.num_sticks, p.num_values, p.dim_z, p.dim_x_freq

        def refuse(what):
            return InvalidParameterError(
                f"restored plan tables do not fit the index plan: {what}")

        try:
            split = None if r.split_x is None \
                else tuple(int(v) for v in r.split_x)
            grid_w = int(r.grid_w)
        except (TypeError, ValueError) as exc:
            raise refuse(f"split_x {r.split_x!r}, grid_w {r.grid_w!r}") \
                from exc
        if not (grid_w == xf if split is None else
                len(split) == 2 and 0 <= split[0] < xf
                and 1 <= split[1] <= xf and grid_w == split[1]):
            raise refuse(f"split_x {split} and grid_w {grid_w} for "
                         f"{xf} frequency x columns")
        cols = grid_w * p.dim_y
        # table -> (length, least value, greatest value)
        want = {"slot_src": ((ns + 1) * nz, 0, nv),
                "scatter_cols": (ns, 0, cols - 1),
                "col_inv": (cols, 0, ns)}
        if self._fused:
            want.update(csr_ptr=(ns + 1, 0, nv), csr_val=(nv, 0, nv - 1),
                        csr_z=(nv, 0, nz - 1))
        else:
            want["value_indices"] = (nv, 0, ns * nz - 1)
        if "conj_sign" in a:
            want["conj_sign"] = (nv, -1, 1)
        got = {}
        for name, (n, lo, hi) in want.items():
            t = a.get(name)
            t = None if t is None else np.asarray(t)
            if t is None or t.shape != (n,):
                raise refuse(f"table {name!r}: expected ({n},), got "
                             f"{None if t is None else t.shape}")
            if t.dtype.kind not in "iu":
                raise refuse(f"table {name!r} is {t.dtype}, not integer")
            if n and not lo <= int(t.min()) <= int(t.max()) <= hi:
                raise refuse(f"table {name!r} holds values in "
                             f"[{int(t.min())}, {int(t.max())}], outside "
                             f"[{lo}, {hi}]")
            got[name] = t
        if self._fused:
            ptr = got["csr_ptr"]
            if ptr[0] != 0 or ptr[-1] != nv or (np.diff(ptr) < 0).any():
                raise refuse(f"csr_ptr does not run from 0 to {nv} "
                             f"without falling")
        if "conj_sign" in got and (got["conj_sign"] == 0).any():
            raise refuse("conj_sign holds 0 (only -1 and 1)")
        return r

    def _commit(self, host: PlanTables, dev) -> dict:
        """The host tables as the tensors the kernels read, on ``dev``."""
        a = host.arrays
        self._split_x = host.split_x
        self._grid_w = int(host.grid_w)

        def i32(name):
            return torch.as_tensor(np.asarray(a[name], np.int32), device=dev)

        tabs = {"slot_src": i32("slot_src"),
                "scatter_cols": torch.as_tensor(
                    np.asarray(a["scatter_cols"], np.int64), device=dev),
                "col_inv": torch.as_tensor(np.asarray(a["col_inv"], np.int64),
                                           device=dev)}
        if self._fused:
            tabs["csr"] = tuple(i32(n) for n in ("csr_ptr", "csr_val",
                                                 "csr_z"))
        else:
            tabs["value_indices"] = i32("value_indices")
        if "conj_sign" in a:
            sgn = np.asarray(a["conj_sign"], np.float64)
            m = np.stack([np.ones_like(sgn), sgn],
                         axis=0 if self._pair_io else -1)
            tabs["conj"] = torch.as_tensor(m, dtype=self.real_dtype,
                                           device=dev)
        self._zero_stick = -1 if not self._r2c \
            or self.index_plan.zero_stick_id is None \
            else int(self.index_plan.zero_stick_id)
        # plane symmetry applies to the x = 0 sub-column when the window
        # starts at 0; otherwise no x = 0 stick exists
        self._complete_x0 = self._r2c and (self._split_x is None
                                           or self._split_x[0] == 0)
        return tabs

    def _make_mats(self, dev) -> dict:
        """The plan's DFT stages on ``dev``."""
        p = self.index_plan
        rdt = self.real_dtype

        def c2c(n, sign, **window):
            return dft.device_c2c(n, sign, device=dev, dtype=rdt, **window)

        gs = 1.0 / float(self.global_size)
        # the z stages in the length's own form, which the fused z
        # kernels and the two-kernel route both take
        mats = {
            "z_b": c2c(p.dim_z, dft.BACKWARD),
            "z_f": c2c(p.dim_z, dft.FORWARD),
            "z_fs": c2c(p.dim_z, dft.FORWARD, scale=gs),
            "y_b": c2c(p.dim_y, dft.BACKWARD),
            "y_f": c2c(p.dim_y, dft.FORWARD),
        }
        # the x matrices restricted to the window (without a split the
        # window is every frequency x, and the selection is the whole)
        x0, w = self._split_x or (0, p.dim_x_freq)
        if self._r2c:
            mats["x_b"] = dft.device_c2r(p.dim_x, rows=(x0, w), device=dev,
                                         dtype=rdt)
            mats["x_f"] = dft.device_r2c(p.dim_x, cols=(x0, w), device=dev,
                                         dtype=rdt)
        else:
            mats["x_b"] = c2c(p.dim_x, dft.BACKWARD, rows=(x0, w))
            mats["x_f"] = c2c(p.dim_x, dft.FORWARD, cols=(x0, w))
        return mats

    def _unfused_tables(self, tabs: dict) -> dict:
        """``tabs`` with the two-kernel route's forward gather map, which
        a fused plan's demoted forward needs, made at its first demotion
        (the z stages are the fused route's own)."""
        p = self.index_plan
        if "value_indices" not in tabs:
            dev = tabs["slot_src"].device
            tabs["value_indices"] = torch.as_tensor(
                np.asarray(p.value_indices, np.int32), device=dev)
        return tabs

    def _tables_on(self, device):
        """``(tables, matrices)`` on ``device``: the plan's own at its
        device (or with ``device`` None), else copies made once per
        device and cached. A device of another type than the plan's is
        refused."""
        if device is None:
            return self._tabs, self._mats
        dev = resolve_device(device)
        if dev.type != self.device.type:
            raise InvalidParameterError(
                f"a plan on {self.device} cannot run on {dev}: build the "
                f"plan with device={dev.type!r}")
        if dev == self.device:
            return self._tabs, self._mats
        cached = self._device_tables.get(dev)
        if cached is None:
            tabs = {k: (tuple(x.to(dev) for x in v) if isinstance(v, tuple)
                        else v.to(dev)) for k, v in self._tabs.items()}
            cached = self._device_tables[dev] = (tabs, self._make_mats(dev))
        return cached

    # -- the plan artifact -------------------------------------------------------
    def export_tables(self) -> PlanTables:
        """Snapshot the plan's tables as host numpy arrays
        (:class:`PlanTables`): with the ``IndexPlan``, everything
        :func:`restore_plan` needs to rebuild this plan without building
        a table. Raises the plan's sticky build failure, as an execution
        does."""
        self._finalize()
        t = self._tabs
        arrays = {"slot_src": t["slot_src"].cpu().numpy(),
                  "scatter_cols": t["scatter_cols"].cpu().numpy(),
                  "col_inv": t["col_inv"].cpu().numpy()}
        if self._fused:
            for name, x in zip(("csr_ptr", "csr_val", "csr_z"), t["csr"]):
                arrays[name] = x.cpu().numpy()
        else:
            arrays["value_indices"] = t["value_indices"].cpu().numpy()
        if "conj" in t:
            c = t["conj"].cpu().numpy()
            arrays["conj_sign"] = (c[1] if self._pair_io
                                   else c[:, 1]).astype(np.int8)
        reasons = {k: v for k, v in self._fused_reasons.items()
                   if k not in self._fused_demotions}
        return PlanTables(arrays=arrays, split_x=self._split_x,
                          grid_w=self._grid_w, fused=self._fused,
                          fused_reasons=reasons)

    def install_aot(self, executables) -> None:
        """The JAX package's AOT prewarm: installs ``jax.export``
        executables. This package compiles no executables (its kernels are
        built once per source, ``ops._build``), so ``None`` and ``{}`` do
        nothing and anything else is refused."""
        if executables:
            raise InvalidParameterError(
                f"install_aot: spfft_tpu_torch has no serialised executables "
                f"to install (got {sorted(executables)}); its CUDA kernels "
                f"build once per source at first use")

    def _finalize(self) -> None:
        """Raise the plan's sticky table-build failure (the ``plan.build``
        seam's second check), as the JAX package's ``_finalize`` raises a
        failed background build on every use."""
        if self._build_exc is not None:
            raise TableBuildError(
                f"the plan's table build failed: {self._build_exc!r}",
                cause=self._build_exc)

    def check_build(self, wait: bool = False) -> None:
        """Raise the sticky :class:`~spfft_tpu_torch.errors.TableBuildError`
        of a failed table build now, not on the first request. The tables
        are built in the constructor, so ``wait`` has nothing to wait
        for."""
        self._finalize()

    def close(self) -> None:
        """Release the plan's copies of its tables on other devices. Never
        raises; idempotent. (The JAX package joins its background table
        build here; this package has none.)"""
        self._device_tables.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: modules may already be gone

    def estimated_device_bytes(self) -> int:
        """Bytes of the device tensors the plan holds for its lifetime:
        its tables, DFT matrices and twiddle tables, on its device and on
        every device it was run on. The host index arrays of the
        ``IndexPlan`` are not device bytes and are not counted."""
        seen, total = set(), 0
        parts = [(self._tabs, self._mats)] + list(self._device_tables.values())
        for tabs, mats in parts:
            ts = [x for v in tabs.values()
                  for x in (v if isinstance(v, tuple) else (v,))]
            for m in mats.values():
                ts += list(m.tensors)
            for x in ts:
                if x.data_ptr() not in seen:
                    seen.add(x.data_ptr())
                    total += x.numel() * x.element_size()
        return total

    # -- the runtime demotion ladder ---------------------------------------------
    def _fused_on(self, which: str) -> bool:
        """Whether the ``which`` direction runs its fused kernel now: a
        fused plan's, unless demoted (except while its re-probe runs)."""
        rec = self._fused_demotions.get(which)
        return self._fused and (rec is None or rec["probing"])

    def _seam(self, key, which: str) -> None:
        """The trace-time ``kernel.launch`` seam of an executable that runs
        the ``which`` fused kernel (:func:`ops.fused_kernel.trace_seam`)."""
        if self._fused_on(which):
            fused_kernel.trace_seam(self._seam_keys, key + (which,))

    def _invalidate(self, which: str) -> None:
        """Forget the executables that ran the ``which`` fused kernel (the
        JAX package's ``_invalidate_fused_jits``): its own entry, and every
        batched and round-trip one."""
        own = "backward" if which == "dec" else "forward"
        self._seam_keys.keep(lambda k: k[0] not in (
            own, "backward_batched", "forward_batched", "pair", "iterate"))

    def _fused_demote(self, which: str, exc: BaseException,
                      probing: bool) -> None:
        """Demote the ``which`` direction to the two-kernel route after a
        failure charged to the device (``spfft_tpu/plan.py:811-860``)."""
        rec = self._fused_demotions.get(which)
        if rec is None:
            rec = self._fused_demotions[which] = {
                "reason": "", "unfused_ok": 0, "probes": 0,
                "probing": False, "permanent": False}
        rec["reason"] = f"runtime: {type(exc).__name__}: {exc}"
        rec["unfused_ok"] = 0
        rec["probing"] = False
        if probing:
            rec["probes"] += 1
            rec["permanent"] = rec["probes"] >= self.FUSED_REPROBE_MAX
        self._fused_reasons[which] = rec["reason"]
        obs.GLOBAL_COUNTERS.inc("spfft_fused_demotions_total", which=which)
        if probing:
            obs.GLOBAL_COUNTERS.inc("spfft_fused_reprobes_total",
                                    which=which, outcome="failed")
        obs.record_event("fused.demote", which=which, reason=rec["reason"],
                         permanent=rec["permanent"])
        logger.warning(
            "spfft_tpu_torch: fused %s kernel failed at runtime (%r) — "
            "demoted to the two-kernel route%s", which, exc,
            " permanently" if rec["permanent"] else
            f" (re-probe after {self.FUSED_REPROBE_AFTER} calls)")
        self._invalidate(which)

    def _fused_readmit(self, which: str) -> None:
        """A re-probe succeeded: lift the demotion and count it."""
        rec = self._fused_demotions.pop(which, None)
        self._fused_reasons.pop(which, None)
        obs.GLOBAL_COUNTERS.inc("spfft_fused_reprobes_total", which=which,
                                outcome="readmitted")
        obs.record_event("fused.readmit", which=which,
                         probes=rec["probes"] if rec else 0)
        logger.info("spfft_tpu_torch: fused %s kernel re-probe succeeded "
                    "after %d failed probe(s) — readmitted", which,
                    rec["probes"] if rec else 0)

    def fused_demotions(self) -> dict:
        """Snapshot of the runtime demotion ladder, per direction:
        ``{"dec"/"cmp": {"reason", "unfused_ok", "probes", "probing",
        "permanent"}}`` — empty when nothing is demoted."""
        return {k: dict(v) for k, v in self._fused_demotions.items()}

    def _guarded(self, which: str, call, per_call: bool = True):
        """Run ``call()`` — one execution whose ``which`` stage reads
        :meth:`_fused_on` when it runs — under the demotion ladder
        (``spfft_tpu/plan.py:862-900``): a failure charged to the device
        demotes the direction and runs the same call again on the
        two-kernel route; other errors (a bad request, a kernel that does
        not build) propagate untouched. ``per_call`` consults the
        ``kernel.launch`` seam once per fused call, as the JAX package's
        public entries do, and counts a demoted direction's calls toward
        its re-probe; the round trips, which the JAX package runs outside
        its ladder, do neither."""
        rec = self._fused_demotions.get(which)
        probing = rec is not None and rec["probing"]
        if not self._fused or (rec is not None and not probing):
            out = call()
            if rec is not None and per_call and not rec["permanent"]:
                rec["unfused_ok"] += 1
                if rec["unfused_ok"] >= self.FUSED_REPROBE_AFTER:
                    rec["probing"] = True
                    self._invalidate(which)
            return out
        try:
            if per_call:
                faults.check_site("kernel.launch")
            out = call()
        except Exception as exc:
            if not faults.attributes_device(exc):
                raise
            self._fused_demote(which, exc, probing)
            return call()
        if probing:
            self._fused_readmit(which)
        return out

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
    # the tables by the names the kernels' callers read them by
    _slot_src = property(lambda self: self._tabs["slot_src"])
    _csr = property(lambda self: self._tabs.get("csr"))
    _value_indices = property(lambda self: self._tabs.get("value_indices"))
    _conj = property(lambda self: self._tabs.get("conj"))
    _scatter_cols = property(lambda self: self._tabs["scatter_cols"])
    _col_inv = property(lambda self: self._tabs["col_inv"])

    def _bwd_space(self, v: torch.Tensor, tabs: dict = None,
                   mats: dict = None, key=None):
        """Values in the plan's layout, ``(B?, N, 2)`` or ``(B?, 2, N)``,
        -> planar space: ``(xr, xi)`` each ``(B?, dim_z, dim_y, dim_x)``
        for C2C, the real slab for R2C (the JAX package's
        ``_bwd_space_tp``). The z stage runs the fused kernel while the
        ``"dec"`` direction is not demoted, else the two-kernel route's
        kernels; ``key`` names the executable for the fault seam (None:
        no seam). ``tabs`` / ``mats`` default to the plan's own."""
        p = self.index_plan
        if tabs is None:
            tabs, mats = self._tabs, self._mats
        if "conj" in tabs:
            v = v * tabs["conj"]
        if self._fused_on("dec"):
            if key is not None:
                self._seam(key, "dec")
            sr, si = fused_kernel.decompress_zdft(
                v, tabs["slot_src"], mats["z_b"], p.dim_z, self._pair_io,
                self._zero_stick)
        else:
            sr, si = gather_kernel.decompress(v, tabs["slot_src"], p.dim_z,
                                              self._pair_io)
            zid = self._zero_stick
            if zid >= 0:  # in place: the sticks are this call's own
                sr[..., zid, :], si[..., zid, :] = \
                    stages.complete_stick_hermitian(sr[..., zid, :],
                                                    si[..., zid, :])
            sr, si = dft_kernel.pdft_last(sr, si, mats["z_b"])
        return self._backward_after_z(sr, si, tabs, mats)

    def _backward_after_z(self, sr, si, tabs: dict, mats: dict):
        """z-transformed sticks ``(B?, S + 1, dim_z)`` (the last one the
        zero sentinel stick) -> planar space: placement into the
        transposed plane grid, then one xy call over every plane of the
        batch."""
        p = self.index_plan
        lead = tuple(sr.shape[:-2])
        gr = stages.sticks_to_grid_padded(sr, tabs["col_inv"], self._grid_w,
                                          p.dim_y)
        gi = stages.sticks_to_grid_padded(si, tabs["col_inv"], self._grid_w,
                                          p.dim_y)
        planes = (-1, self._grid_w, p.dim_y)
        gr, gi = gr.view(planes), gi.view(planes)
        if self._r2c:
            if self._complete_x0:
                stages.complete_plane_hermitian_t(gr, gi)
            out = dft_kernel.pdft2_cr(gr, gi, mats["y_b"], mats["x_b"])
            return out.reshape(lead + (p.dim_z, p.dim_y, p.dim_x))
        xr, xi = dft_kernel.pdft2(gr, gi, mats["y_b"], mats["x_b"])
        shape = lead + (p.dim_z, p.dim_y, p.dim_x)
        return xr.reshape(shape), xi.reshape(shape)

    def _fwd_values(self, space, scaled: bool, tabs: dict, mats: dict, key,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Planar space (as :meth:`_bwd_space` returns it; contiguous)
        -> values in the plan's layout (the JAX package's
        ``_fwd_values_tp``), FULL scaling folded into the z matrix,
        written into ``out`` where given (a donated values tensor). The
        z stage as in :meth:`_bwd_space`, direction ``"cmp"``."""
        p = self.index_plan
        planes = (-1, p.dim_y, p.dim_x)
        if self._r2c:
            lead = tuple(space.shape[:-3])
            gr, gi = dft_kernel.prdft2(space.reshape(planes), mats["x_f"],
                                       mats["y_f"])
        else:
            lead = tuple(space[0].shape[:-3])
            gr, gi = dft_kernel.pdft2(space[0].reshape(planes),
                                      space[1].reshape(planes), mats["x_f"],
                                      mats["y_f"])
        grid = lead + (p.dim_z, self._grid_w, p.dim_y)
        sr = stages.grid_to_sticks(gr.reshape(grid), tabs["scatter_cols"])
        si = stages.grid_to_sticks(gi.reshape(grid), tabs["scatter_cols"])
        zname = "z_fs" if scaled else "z_f"
        if self._fused_on("cmp"):
            self._seam(key, "cmp")
            res = fused_kernel.zdft_compress(sr, si, mats[zname], tabs["csr"],
                                             self._pair_io, out=out)
        else:
            if self._fused:
                tabs = self._unfused_tables(tabs)
            yr, yi = dft_kernel.pdft_last(sr, si, mats[zname])
            res = gather_kernel.compress(yr, yi, tabs["value_indices"],
                                         self._pair_io, out=out)
        return res if "conj" not in tabs else res.mul_(tabs["conj"])

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
    def backward(self, values, device=None) -> torch.Tensor:
        """Frequency -> space. ``values`` is ``(num_values,)`` complex or
        ``(num_values, 2)`` interleaved (or ``(2, num_values)`` for
        pair-layout plans), a tensor or a numpy array. Returns the
        unnormalised inverse DFT (details.rst "Transform Definition") on
        the plan's device, in the plan's real type (float32, or float64
        for a double plan): the ``(dim_z, dim_y, dim_x, 2)`` slab for
        C2C, the real ``(dim_z, dim_y, dim_x)`` slab for R2C. ``device``
        runs the call on another device of the plan's type, with the
        plan's tables copied there once (the JAX package's pool
        placement); None is the plan's own."""
        tabs, mats = self._tables_on(device)
        v = self._coerce_values(values, tabs["slot_src"].device)
        self._finalize()
        with timed_transform("backward") as box:
            box.value = self._guarded("dec", lambda: self._public_space(
                self._bwd_space(v, tabs, mats, ("backward",))))
        return box.value

    def forward(self, space, scaling: Scaling = Scaling.NONE,
                device=None) -> torch.Tensor:
        """Space -> frequency. ``space`` is the ``(dim_z, dim_y, dim_x)``
        slab: complex or ``(..., 2)`` interleaved for C2C, real for R2C
        (a complex slab is refused). Returns ``(num_values, 2)`` values
        of the plan's real type — ``(2, num_values)`` for pair-layout
        plans;
        ``Scaling.FULL`` multiplies by 1/(Nx·Ny·Nz) (details.rst
        "Normalization"), folded into the z matrix. ``device`` as in
        :meth:`backward`."""
        scaling = Scaling(scaling)
        tabs, mats = self._tables_on(device)
        sp = self._planar_space(self._coerce_space(
            space, tabs["slot_src"].device))
        full = scaling is Scaling.FULL
        self._finalize()
        with timed_transform("forward") as box:
            box.value = self._guarded("cmp", lambda: self._fwd_values(
                sp, full, tabs, mats, ("forward", full)))
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

    def _stack_coerced(self, items, coerce, device) -> torch.Tensor:
        """Stack per-transform inputs into one batch on ``device``. Rows
        that are not on a device yet are coerced and stacked on the host
        and moved in ONE transfer (B separate copies to the card, then a
        device concatenation, would cost more)."""
        items = list(items)
        if not items:
            raise InvalidParameterError("a batch needs at least one row")
        if any(_on_device(v) for v in items):
            return torch.stack([coerce(v, device) for v in items])
        host = torch.device("cpu")
        return torch.stack([coerce(v, host) for v in items]).to(device)

    def _batch_tensor(self, batch, per, device) -> Optional[torch.Tensor]:
        """A tensor or prestaged array already shaped ``(B,) + per`` ->
        a contiguous tensor of the plan's real type on ``device``; None
        otherwise."""
        if isinstance(batch, torch.Tensor) and batch.dim() == len(per) + 1 \
                and tuple(batch.shape[1:]) == per and not batch.is_complex():
            return batch.to(device, self.real_dtype).contiguous()
        if self._prestaged(batch, per):  # copied, as _coerce_values does
            return torch.tensor(batch, device=device)
        return None

    def backward_batched(self, values_batch, device=None) -> torch.Tensor:
        """Backward-execute a batch over this plan: ``values_batch`` is a
        ``(B,) + row`` tensor or array in the plan's value layout
        (:meth:`batch_row_template`), or a sequence of per-transform
        values in any form :meth:`backward` takes. Returns the ``(B,
        ...)`` space slabs, each band equal to :meth:`backward` of its
        row, with one launch of each kernel whatever B is. ``device`` as
        in :meth:`backward`."""
        tabs, mats = self._tables_on(device)
        dev = tabs["slot_src"].device
        per = self.batch_row_template("values")[0]
        v = self._batch_tensor(values_batch, per, dev)
        if v is None:
            v = self._stack_coerced(values_batch, self._coerce_values, dev)
        key = ("backward_batched", v.shape[0])
        self._finalize()
        with timed_transform("backward_batched") as box:
            box.value = self._guarded("dec", lambda: self._public_space(
                self._bwd_space(v, tabs, mats, key)))
        return box.value

    def forward_batched(self, space_batch, scaling: Scaling = Scaling.NONE,
                        device=None) -> torch.Tensor:
        """Forward-execute a batch of space slabs (a ``(B,) + slab``
        tensor or array, or a sequence of slabs in any form
        :meth:`forward` takes). Returns ``(B, num_values, 2)`` values —
        ``(B, 2, num_values)`` for pair-layout plans. ``device`` as in
        :meth:`backward`."""
        scaling = Scaling(scaling)
        tabs, mats = self._tables_on(device)
        dev = tabs["slot_src"].device
        per = self.batch_row_template("space")[0]
        sp = self._batch_tensor(space_batch, per, dev)
        if sp is None:
            sp = self._stack_coerced(space_batch, self._coerce_space, dev)
        full = scaling is Scaling.FULL
        key = ("forward_batched", full, sp.shape[0])
        sp = self._planar_space(sp)
        self._finalize()
        with timed_transform("forward_batched") as box:
            box.value = self._guarded("cmp", lambda: self._fwd_values(
                sp, full, tabs, mats, key))
        return box.value

    # -- the round trip --------------------------------------------------------
    def _pair(self, v: torch.Tensor, fn, fn_args, scaled: bool, key,
              out: Optional[torch.Tensor] = None):
        """backward -> ``fn(space, *fn_args)`` -> forward on coerced
        values, each direction under the demotion ladder (without the
        JAX package's per-call seam, which its round trips do not
        consult). Without ``fn`` the planar space goes straight on; with
        it, ``fn`` sees the public layout and its result is checked as
        :meth:`forward` checks a slab. ``out`` receives the values."""
        tabs, mats = self._tabs, self._mats
        space = self._guarded("dec", lambda: self._bwd_space(
            v, tabs, mats, key), per_call=False)
        if fn is not None:
            res = fn(self._public_space(space), *fn_args)
            space = self._planar_space(self._coerce_space(res))
        return self._guarded("cmp", lambda: self._fwd_values(
            space, scaled, tabs, mats, key, out), per_call=False)

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
        throughout. Returns the values in the plan's layout: with
        ``donate_inputs``, written into the values tensor given (see the
        class docstring)."""
        scaling = Scaling(scaling)
        v = self._coerce_values(values)
        full = scaling is Scaling.FULL
        self._finalize()
        with timed_transform("apply_pointwise") as box:
            # donating: the result goes into the coerced values, the
            # caller's own tensor where it needed no conversion
            box.value = self._pair(v, fn, fn_args, full, ("pair", fn, full),
                                   v if self.donate_inputs else None)
        return box.value

    def iterate_pointwise(self, values, fn, *fn_args, steps: int,
                          scaling: Scaling = Scaling.FULL) -> torch.Tensor:
        """``steps`` round trips values -> backward -> ``fn`` -> forward
        -> values, as :meth:`apply_pointwise` runs one. ``scaling``
        defaults to FULL so that the iteration is a fixed-point map.
        Returns the final values (with ``donate_inputs``, in the values
        tensor given)."""
        scaling = Scaling(scaling)
        if int(steps) < 0:
            raise InvalidParameterError(f"steps must be >= 0, got {steps}")
        v = self._coerce_values(values)
        full = scaling is Scaling.FULL
        key = ("iterate", fn, full, int(steps))
        out = v if self.donate_inputs else None
        self._finalize()
        with timed_transform("iterate_pointwise") as box:
            for _ in range(int(steps)):
                v = self._pair(v, fn, fn_args, full, key, out)
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


def restore_plan(index_plan: IndexPlan, tables: PlanTables,
                 precision: str = "single", **plan_kwargs) -> TransformPlan:
    """Rebuild a :class:`TransformPlan` from a plan artifact: the index
    plan, and the ``tables`` :meth:`TransformPlan.export_tables` gave
    (``spfft_tpu/plan.py:2086``). No table is built: the host tables go
    to the device as they are, and the result is bit for bit the
    exporting plan's. ``plan_kwargs`` as in :class:`TransformPlan`
    (device, fused, donate_inputs, max_rel_error); ``fused`` must be the
    exporting plan's route."""
    if not isinstance(tables, PlanTables):
        raise InvalidParameterError(
            f"restore_plan takes the PlanTables of export_tables, got "
            f"{type(tables).__name__}")
    plan_kwargs.setdefault("fused", tables.fused or bool(
        tables.fused_reasons))
    return TransformPlan(index_plan, precision=precision, _restore=tables,
                         **plan_kwargs)


def make_local_plan(transform_type: TransformType, dim_x: int, dim_y: int,
                    dim_z: int, triplets, precision: str = "single",
                    device=None, fused: bool = True,
                    donate_inputs: bool = False,
                    max_rel_error: Optional[float] = None) -> TransformPlan:
    """Build a local plan from raw index triplets (reference:
    grid.hpp:138-141). The plan runs on ``device``: CUDA by default,
    ``"cpu"`` for the plain PyTorch versions. ``fused=False`` takes the
    two-kernel route (see the module docstring). ``donate_inputs`` and
    ``max_rel_error`` as in :class:`TransformPlan`."""
    plan = build_index_plan(TransformType(transform_type), dim_x, dim_y,
                            dim_z, np.asarray(triplets))
    return TransformPlan(plan, precision=precision, device=device,
                         fused=fused, donate_inputs=donate_inputs,
                         max_rel_error=max_rel_error)
