"""The DFT stage kernels: ports of ``spfft_tpu/ops/dft_kernel.py``
``pdft2``, ``prdft2`` and ``pdft2_cr`` (the Pallas kernel ``_kernel2`` in
modes ``cc``, ``rc`` and ``cr``, launched at ``dft_kernel.py:277``), and
of ``pdft_last`` (the single-stage ``_stage_kernel``, launched at
``dft_kernel.py:165``).

* :func:`pdft_last` is one planar complex DFT along the minor axis,
  ``(..., K) -> (..., N)`` against ``mats`` ``(K, N)``: the z stage of
  the two-kernel route (rows are sticks). One launch of the stage
  kernel in mode CC, stored straight; the JAX kernel's Karatsuba triple
  becomes the tile's 4-product form.

* :func:`pdft2` maps planar complex ``(P, A, B)`` to ``(P, B', A')``: a
  DFT over the minor axis B against ``mats1`` ``(B, B')``, a swap of the
  two minor axes, a DFT over A against ``mats2`` ``(A, A')``.
* :func:`prdft2` (R2C forward head) takes a real ``(P, A, B)``; its first
  stage is the real DFT to the half spectrum (``mats1`` from
  ``dft.r2c_mats``).
* :func:`pdft2_cr` (R2C backward tail) returns a real ``(P, B', A')``;
  its second stage is the real inverse DFT (``mats2`` from
  ``dft.c2r_mats``).

All matrix pairs may be rectangular (the split-x window's row- and
column-selected matrices).

On a CUDA tensor each wrapper launches ``csrc/dft2.cu``'s stage kernel
twice: the first launch stores its result transposed within each plane,
the second stores straight (see that file for why the TPU's in-VMEM swap
has no direct counterpart, and what bounds the kernel: FP32 operations).
Each wrapper counts its own launches, two per call, in ``.launches``
(:func:`pdft_last`: one per call). On a CPU tensor it runs the plain
version from :mod:`spfft_tpu_torch.ops.dft`.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidParameterError
from . import _build, dft

_P = ctypes.c_void_p
#: ``mode`` argument of csrc/dft2.cu's ``spfft_dft_stage`` (``TileMode`` of
#: csrc/cdft_tile.cuh)
_MODES = {"cc": 0, "rc": 1, "cr": 2}
#: its argument types: the mode, the input planes, the matrix pair, the
#: output planes, then M, K, N, plane_rows and the stream
_ARGS = [ctypes.c_int] + [_P] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, _P]


def _stage(mode: str, ins, mats, outs, plane_rows: int) -> None:
    """One launch of the stage kernel in ``mode``: rows of ``ins`` (minor
    axis K; one real plane in mode rc) against ``mats`` (K, N) into
    ``outs`` (one real plane in mode cr)."""
    k, n = mats[0].shape
    m = ins[0].numel() // k
    xr, xi = (*ins, None)[:2]
    yr, yi = (*outs, None)[:2]
    fn = _build.function("dft2.cu", "spfft_dft_stage", _ARGS)
    _build.launch(fn, f"dft2 stage {mode}", xr.device, _MODES[mode],
                  *(None if t is None else t.data_ptr()
                    for t in (xr, xi, *mats, yr, yi)),
                  m, k, n, plane_rows)


def _check(name: str, ins, mats1, mats2):
    """The operand rules of the three wrappers; returns ``(p, a, b,
    b_out, a_out)``."""
    x = ins[0]
    if x.dim() != 3:
        raise InvalidParameterError(
            f"{name}: expected (P, A, B) operands, got {tuple(x.shape)}")
    p, a, b = x.shape
    b_out = mats1[0].shape[1]
    a_out = mats2[0].shape[1]
    dev = x.device
    _build.require(x, f"{name} input", torch.float32)
    for t in ins[1:]:
        _build.require(t, f"{name} input", torch.float32, x.shape, dev)
    for m, shape in ((mats1, (b, b_out)), (mats2, (a, a_out))):
        for c in m:
            _build.require(c, f"{name} matrix", torch.float32, shape, dev)
    return p, a, b, b_out, a_out


def _run2(wrapper, modes, ins, mats1, mats2, plain):
    """The body of the three wrappers: the stage kernel in ``modes[0]``
    stored transposed within each plane, then in ``modes[1]`` stored
    straight, each launch counted in ``wrapper.launches``; ``plain`` on a
    CPU tensor. Mode cr as the second stage gives one real output."""
    name = wrapper.__name__
    p, a, b, b_out, a_out = _check(name, ins, mats1, mats2)
    x = ins[0]
    if not _build.on_cuda(x, name):
        return plain(*ins, mats1, mats2)
    real_out = modes[1] == "cr"
    out = tuple(torch.empty((p, b_out, a_out), dtype=torch.float32,
                            device=x.device)
                for _ in range(1 if real_out else 2))
    if x.numel() == 0:
        for t in out:
            t.zero_()
    else:
        mid = tuple(torch.empty((p, b_out, a), dtype=torch.float32,
                                device=x.device) for _ in range(2))
        _stage(modes[0], ins, mats1, mid, plane_rows=a)
        wrapper.launches += 1
        _stage(modes[1], mid, mats2, out, plane_rows=0)
        wrapper.launches += 1
    return out[0] if real_out else out


def pdft_last(xr: torch.Tensor, xi: torch.Tensor, mats):
    """Planar complex DFT along the minor axis, ``(..., K) -> (..., N)``
    against the ``(cr, ci)`` pair ``(K, N)``; any leading axes are rows.
    Each kernel launch (one per call) adds one to
    ``pdft_last.launches``."""
    if xr.dim() < 1:
        raise InvalidParameterError(
            f"pdft_last: expected (..., K) operands, got {tuple(xr.shape)}")
    k = xr.shape[-1]
    dev = xr.device
    _build.require(xr, "pdft_last input", torch.float32)
    _build.require(xi, "pdft_last input", torch.float32, xr.shape, dev)
    n = mats[0].shape[1] if mats[0].dim() == 2 else -1
    for c in mats:
        _build.require(c, "pdft_last matrix", torch.float32, (k, n), dev)
    if not _build.on_cuda(xr, "pdft_last"):
        return dft.pdft_last(xr, xi, mats)
    out = tuple(torch.empty(xr.shape[:-1] + (n,), dtype=torch.float32,
                            device=dev) for _ in range(2))
    if xr.numel() == 0 or n == 0:
        for t in out:
            t.zero_()
        return out
    _stage("cc", (xr, xi), mats, out, plane_rows=0)
    pdft_last.launches += 1
    return out


def pdft2(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """``(P, A, B) -> (P, B', A')`` planar complex DFT over both minor
    axes; ``mats1``/``mats2`` are ``(cr, ci)`` pairs of shapes
    ``(B, B')`` and ``(A, A')``. Each kernel launch adds one to
    ``pdft2.launches`` (two per call)."""
    return _run2(pdft2, ("cc", "cc"), (xr, xi), mats1, mats2,
                 dft.pdft2_minor)


def prdft2(x: torch.Tensor, mats1, mats2):
    """Real ``(P, A, B) -> (P, B', A')`` planar: the real DFT over B to
    the half spectrum (``mats1`` ``(B, B')`` from ``dft.r2c_mats`` or its
    column window), swap, a complex DFT over A (``mats2`` ``(A, A')``).
    Each kernel launch adds one to ``prdft2.launches`` (two per call)."""
    return _run2(prdft2, ("rc", "cc"), (x,), mats1, mats2,
                 dft.prdft2_minor)


def pdft2_cr(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """Planar ``(P, A, B) -> `` real ``(P, B', A')``: a complex DFT over
    B (``mats1`` ``(B, B')``), swap, the real inverse DFT over A
    (``mats2`` ``(A, A')`` from ``dft.c2r_mats`` or its row window).
    Each kernel launch adds one to ``pdft2_cr.launches`` (two per
    call)."""
    return _run2(pdft2_cr, ("cc", "cr"), (xr, xi), mats1, mats2,
                 dft.pdft2_minor_cr)


pdft_last.launches = 0
pdft2.launches = 0
prdft2.launches = 0
pdft2_cr.launches = 0
