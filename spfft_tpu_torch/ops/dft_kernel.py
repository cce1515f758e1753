"""The xy DFT stage kernel: port of ``spfft_tpu/ops/dft_kernel.py``
``pdft2`` (the Pallas kernel ``_kernel2`` in mode ``cc``, launched at
``dft_kernel.py:277``).

:func:`pdft2` maps planar complex ``(P, A, B)`` to ``(P, B', A')``: a DFT
over the minor axis B against ``mats1`` ``(B, B')``, a swap of the two
minor axes, a DFT over A against ``mats2`` ``(A, A')``. Both matrix
pairs may be rectangular (the split-x window's row- and column-selected
matrices).

On a CUDA tensor it launches ``csrc/dft2.cu``'s stage kernel twice: the
first launch stores its result transposed within each plane, the second
stores straight (see that file for why the TPU's in-VMEM swap has no
direct counterpart, and what bounds the kernel: FP32 operations). On a
CPU tensor it runs the plain version, :func:`spfft_tpu_torch.ops.dft.
pdft2_minor`.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidParameterError
from . import _build, dft

_STAGE_ARGS = ([ctypes.c_void_p] * 6
               + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p])


def _stage(xr, xi, mats, out_shape, plane_rows: int):
    """One launch of the stage kernel: rows of ``xr``/``xi`` (minor
    axis K) against ``mats`` (K, N)."""
    k, n = mats[0].shape
    yr = torch.empty(out_shape, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    m = xr.numel() // k
    fn = _build.function("dft2.cu", "spfft_dft_stage", _STAGE_ARGS)
    _build.launch(fn, "pdft2 stage kernel", xr.device, xr.data_ptr(),
                  xi.data_ptr(), mats[0].data_ptr(), mats[1].data_ptr(),
                  yr.data_ptr(), yi.data_ptr(), m, k, n, plane_rows)
    pdft2.launches += 1
    return yr, yi


def pdft2(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """``(P, A, B) -> (P, B', A')`` planar complex DFT over both minor
    axes; ``mats1``/``mats2`` are ``(cr, ci)`` pairs of shapes
    ``(B, B')`` and ``(A, A')``. Each kernel launch adds one to
    ``pdft2.launches`` (two per call)."""
    if xr.dim() != 3:
        raise InvalidParameterError(
            f"pdft2: expected (P, A, B) operands, got {tuple(xr.shape)}")
    p, a, b = xr.shape
    b_out = mats1[0].shape[1]
    a_out = mats2[0].shape[1]
    dev = xr.device
    _build.require(xr, "pdft2 xr", torch.float32)
    _build.require(xi, "pdft2 xi", torch.float32, xr.shape, dev)
    for m, shape in ((mats1, (b, b_out)), (mats2, (a, a_out))):
        for c in m:
            _build.require(c, "pdft2 matrix", torch.float32, shape, dev)
    if not _build.on_cuda(xr, "pdft2"):
        return dft.pdft2_minor(xr, xi, mats1, mats2)
    if xr.numel() == 0:
        z = torch.zeros((p, b_out, a_out), dtype=torch.float32, device=dev)
        return z, z.clone()
    gr, gi = _stage(xr, xi, mats1, (p, b_out, a), plane_rows=a)
    return _stage(gr, gi, mats2, (p, b_out, a_out), plane_rows=0)


pdft2.launches = 0
