"""Matmul-DFT: FFT stages as products against plan-time matrices
(counterpart of ``spfft_tpu.ops.dft``).

Every DFT stage of the plan contracts the minor axis of a planar
(separate real and imaginary tensors) operand against a plan-time
matrix pair, with any scale folded into the matrix values, in the plan's
real type: float32 for a single-precision plan, float64 for a double one
(every matrix function takes ``dtype``; the values are computed in
float64 and rounded once). The float32 matrices are the JAX package's
bit for bit, so the two packages contract against the same constants.

The matrices a plan hands its kernels are :class:`DftMats` (from
:func:`device_c2c`, and for the real x axis of an R2C plan
:func:`device_r2c` / :func:`device_c2r`): the matrix pair plus the
transform it stands for (kind, length, sign, scale, input and output
windows) and the FFT form's twiddle table, so that ``ops.dft_kernel``
can compute the same function as an FFT (:func:`fft_factors`,
:func:`rfft_factors`, :func:`fft_twiddles`).

This module holds the plain PyTorch forms: :func:`pdft_last` (one stage)
and :func:`pdft2_minor` (two stages around a swap of the two minor
axes; :func:`cdft2_xy` swaps back, the distributed xy stage), and their
real-transform twins :func:`prdft_last`, :func:`pirdft_last`,
:func:`prdft2_minor` (R2C forward head) and
:func:`pdft2_minor_cr` (C2R backward tail). They are the plain versions
the CUDA kernels of ``ops.dft_kernel`` and ``ops.fused_kernel`` are held
to, and what those wrappers run on a CPU tensor.

Axes above :data:`MATMUL_DFT_MAX` (the two-stage Cooley-Tukey form and
the direct prime fallback of the JAX package, which also runs an R2C x
axis direct up to 1024) are not in this slice of the port: every matrix
builder raises for them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..errors import DeviceError, InvalidParameterError

#: Longest axis of the direct matmul-DFT form.
MATMUL_DFT_MAX = 512

#: Longest unfactorable axis the JAX package runs in the direct form;
#: kept for :func:`mdft_coverable`, which the precision model reads.
MATMUL_DFT_DIRECT_FALLBACK_MAX = 1024

BACKWARD = +1   # unnormalised inverse DFT (e^{+2 pi i k n / N})
FORWARD = -1    # plain DFT


def _roots(km: np.ndarray, n: int, sign: int, dtype) -> np.ndarray:
    """e^(sign 2 pi i k m / n) for the products ``km`` of a DFT matrix's
    indices, complex128. For a float64 matrix the products are reduced
    mod n (the angles would otherwise carry the float64 error of angles
    up to 2 pi n, about 1e-13 at n = 512) and the parts that are 0 are
    exactly 0 (cos(pi / 2), sin(pi) ...: the imaginary weights of the
    self-conjugate bins of a real DFT vanish, as its FFT form drops
    them). A float32 matrix takes the angles as they are, so that it
    stays the JAX package's bit for bit."""
    if np.dtype(dtype) != np.float64:
        return np.exp(sign * 2j * np.pi * km / n)
    w = np.exp(sign * 2j * np.pi * (km % n) / n)
    re, im = w.real.copy(), w.imag.copy()
    re[np.abs(re) < 1e-12] = 0.0  # |a nonzero part| >= sin(2 pi / n)
    im[np.abs(im) < 1e-12] = 0.0
    return re + 1j * im


@functools.lru_cache(maxsize=32)
def _build_dft_mats(n: int, sign: int, scale: float, dtype=np.float32):
    """(Cr, Ci) numpy constants of ``dtype`` for the length-``n`` DFT
    with ``scale`` folded in — in float32 the first two of the JAX
    package's Karatsuba triple, bit for bit (this package uses the
    4-product form, which needs no Cr + Ci sum)."""
    k = np.arange(n)
    m = _roots(np.outer(k, k), n, sign, dtype) * scale
    return (np.ascontiguousarray(m.real.astype(dtype)),
            np.ascontiguousarray(m.imag.astype(dtype)))


def _check_direct(n: int) -> None:
    if n > MATMUL_DFT_MAX:
        raise InvalidParameterError(
            f"axis length {n} exceeds MATMUL_DFT_MAX={MATMUL_DFT_MAX}: the "
            f"two-stage and prime-fallback DFT forms for longer axes are "
            f"not in this slice of the port (a later slice adds them)")


def c2c_mats(n: int, sign: int, scale: float = 1.0, dtype=np.float32):
    """Matrices ``(cr, ci)``, each ``(n, n)`` of numpy ``dtype``, for a
    complex length-``n`` DFT with ``scale`` folded in. ``sign=BACKWARD``
    with ``scale=1`` is the library's unnormalised inverse (ifft * n)."""
    _check_direct(n)
    s = +1 if sign == BACKWARD else -1
    return _build_dft_mats(int(n), s, float(scale), np.dtype(dtype).type)


@functools.lru_cache(maxsize=32)
def _rdft_mats(n: int, scale: float, dtype=np.float32):
    """Forward real-to-halfspectrum matrices ``(n, n//2+1)``: Yr = X @ A,
    Yi = X @ B (in float32 the JAX package's ``_rdft_mats``, bit for
    bit)."""
    xf = n // 2 + 1
    k = np.arange(xf)
    m = _roots(np.outer(np.arange(n), k), n, -1, dtype) * scale
    return (np.ascontiguousarray(m.real.astype(dtype)),
            np.ascontiguousarray(m.imag.astype(dtype)))


@functools.lru_cache(maxsize=32)
def _irdft_mats(n: int, scale: float, dtype=np.float32):
    """Halfspectrum-to-real matrices ``(n//2+1, n)``: x = Yr @ A + Yi @ B
    (in float32 the JAX package's ``_irdft_mats``, bit for bit). From
    hermitian symmetry, x[m] = sum_k w[k] (Yr[k] cos(2 pi k m / n) -
    Yi[k] sin(2 pi k m / n)) with w = 1 for the self-conjugate bins (k =
    0 and, for even n, k = n/2) and 2 otherwise: the doubling stands in
    for the missing negative-frequency half."""
    xf = n // 2 + 1
    k = np.arange(xf)
    w = np.full(xf, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    if np.dtype(dtype) == np.float64:
        r = _roots(np.outer(k, np.arange(n)), n, 1, dtype)
        cos, sin = r.real, r.imag
    else:
        ang = 2 * np.pi * np.outer(k, np.arange(n)) / n
        cos, sin = np.cos(ang), np.sin(ang)
    a = (w[:, None] * cos) * scale
    b = (w[:, None] * -sin) * scale
    return (np.ascontiguousarray(a.astype(dtype)),
            np.ascontiguousarray(b.astype(dtype)))


def r2c_mats(n: int, scale: float = 1.0, dtype=np.float32):
    """Matrices ``(a, b)``, each ``(n, n//2+1)`` of numpy ``dtype``, of
    the forward real DFT to the half spectrum (reference rfft layout,
    dim_x_freq = n//2+1 — src/parameters/parameters.cpp:49)."""
    _check_direct(n)
    return _rdft_mats(int(n), float(scale), np.dtype(dtype).type)


def c2r_mats(n: int, scale: float = 1.0, dtype=np.float32):
    """Matrices ``(a, b)``, each ``(n//2+1, n)`` of numpy ``dtype``, of
    the unnormalised inverse real DFT from the half spectrum (irfft *
    n)."""
    _check_direct(n)
    return _irdft_mats(int(n), float(scale), np.dtype(dtype).type)


@functools.lru_cache(maxsize=32)
def sub_rows_mats(n: int, sign: int, rows: tuple, scale: float = 1.0,
                  dtype=np.float32):
    """Row-selected complex DFT matrices ``(len(rows), n)``: the split-x
    contraction from the occupied positions only (wrapped windows are
    non-contiguous row selections)."""
    idx = np.asarray(rows)
    return tuple(np.ascontiguousarray(m[idx])
                 for m in c2c_mats(n, sign, scale, dtype))


@functools.lru_cache(maxsize=32)
def sub_cols_mats(n: int, sign: int, cols: tuple, scale: float = 1.0,
                  dtype=np.float32):
    """Column-selected complex DFT matrices ``(n, len(cols))``: produce
    only the occupied output positions."""
    idx = np.asarray(cols)
    return tuple(np.ascontiguousarray(m[:, idx])
                 for m in c2c_mats(n, sign, scale, dtype))


@functools.lru_cache(maxsize=32)
def sub_rows_c2r_mats(n: int, rows: tuple, scale: float = 1.0,
                      dtype=np.float32):
    """Row-selected inverse-real matrices ``(len(rows), n)``: half-spectrum
    window -> dense real axis (the hermitian weights ride along with
    their rows)."""
    idx = np.asarray(rows)
    return tuple(np.ascontiguousarray(m[idx])
                 for m in c2r_mats(n, scale, dtype))


@functools.lru_cache(maxsize=32)
def sub_cols_r2c_mats(n: int, cols: tuple, scale: float = 1.0,
                      dtype=np.float32):
    """Column-selected forward-real matrices ``(n, len(cols))``: real
    axis -> half-spectrum window."""
    idx = np.asarray(cols)
    return tuple(np.ascontiguousarray(m[:, idx])
                 for m in r2c_mats(n, scale, dtype))


#: the numpy real type of each torch real type the kernels take
NP_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def device_mats(mats, device, dtype=torch.float32) -> tuple:
    """A numpy matrix pair as contiguous tensors of ``dtype`` (float32 or
    float64) on ``device``."""
    return tuple(torch.as_tensor(np.asarray(m, NP_REAL[dtype]),
                                 device=device)
                 for m in mats)


# -- the FFT form of a complex DFT matrix -------------------------------------

@functools.lru_cache(maxsize=1024)
def fft_factors(n: int):
    """The stage radices of the FFT form of a length-``n`` DFT, in the
    order its stages take them (as many 4s as divide ``n``, then a 2, 3s,
    5s), or None where ``n`` has another prime factor or exceeds
    :data:`MATMUL_DFT_MAX`. ``()`` for n = 1."""
    if not 1 <= n <= MATMUL_DFT_MAX:
        return None
    out, rest = [], n
    for p in (4, 2, 3, 5):
        while rest % p == 0:
            out.append(p)
            rest //= p
    return tuple(out) if rest == 1 else None


def radix_code(factors) -> int:
    """``factors`` packed 3 bits each, the first stage lowest: the
    ``radices`` argument of ``csrc/fft.cu``."""
    return sum(p << (3 * i) for i, p in enumerate(factors))


@functools.lru_cache(maxsize=64)
def fft_twiddles(n: int, sign: int) -> np.ndarray:
    """The FFT form's twiddle table, ``e^(sign 2 pi i m / n)`` for m < n,
    complex128 (computed in float64; the kernel gets it rounded once to
    its real type)."""
    s = +1 if sign == BACKWARD else -1
    return np.exp(s * 2j * np.pi * np.arange(n) / n)


def rfft_factors(n: int):
    """The stage radices of the real FFT form of a length-``n`` real DFT:
    those of the complex FFT of its half ``n // 2`` (:func:`fft_factors`),
    or None where ``n`` is odd or its half has another prime factor."""
    return fft_factors(n // 2) if n >= 2 and n % 2 == 0 else None


class DftMats(tuple):
    """A DFT matrix pair that carries the function it stands for, so a
    kernel can compute it as an FFT: the ``kind`` (``"c2c"``: the complex
    pair ``(cr, ci)``; ``"r2c"`` / ``"c2r"``: the real pairs of
    :func:`r2c_mats` / :func:`c2r_mats`), the length ``n``, ``sign``,
    ``scale``, the input window ``rows = (x0, w)`` (row k of the matrix is
    position ``(x0 + k) % L``) and the output window ``cols = (y0, w)``
    (column j is position ``(y0 + j) % L``), where L is ``n`` on a complex
    axis and ``n // 2 + 1`` on a half spectrum (the input of c2r, the
    output of r2c), and ``twiddles``, the device table ``(2, n)`` in the
    matrices' dtype (real row, imaginary row of :func:`fft_twiddles`)
    where :attr:`factors` is a factor list, else None. It unpacks as the
    pair (``cr, ci = mats``), so every matrix-form consumer takes it as
    it takes a plain pair."""

    def __new__(cls, cr, ci, *, n, sign, scale, rows, cols, twiddles,
                kind="c2c"):
        self = super().__new__(cls, (cr, ci))
        self.n, self.sign, self.scale = n, sign, scale
        self.rows, self.cols, self.twiddles = rows, cols, twiddles
        self.kind = kind
        return self

    @property
    def factors(self):
        """The FFT form's stage radices: :func:`fft_factors` of ``n``, or
        for a real kind :func:`rfft_factors`."""
        return fft_factors(self.n) if self.kind == "c2c" \
            else rfft_factors(self.n)


def _window(win, length: int, what: str) -> tuple:
    """``win = (x0, w)`` with ``x0`` taken modulo ``length`` (the whole
    axis where None); raises where ``w`` exceeds ``length``."""
    win = (0, length) if win is None else (int(win[0]) % length, int(win[1]))
    if not 0 <= win[1] <= length:
        raise InvalidParameterError(
            f"{what}: window {win} must lie within the length {length}")
    return win


def _twiddles(n: int, sign: int, factors, device, dtype):
    if factors is None:
        return None
    t = fft_twiddles(n, sign)
    return torch.as_tensor(np.stack([t.real, t.imag]).astype(NP_REAL[dtype]),
                           device=device)


def device_c2c(n: int, sign: int, scale: float = 1.0, rows=None, cols=None,
               device="cpu", dtype=torch.float32) -> DftMats:
    """The length-``n`` complex DFT matrices with ``scale`` folded in, as
    :class:`DftMats` of ``dtype`` (float32 or float64) on ``device``:
    :func:`c2c_mats`, or with ``rows = (x0, w)`` the window's rows
    (:func:`sub_rows_mats` of ``(x0 + arange(w)) % n``), with ``cols =
    (y0, w)`` the window's columns (:func:`sub_cols_mats`), bit for
    bit."""
    n, scale = int(n), float(scale)
    rows = _window(rows, n, "device_c2c")
    cols = _window(cols, n, "device_c2c")
    ri = (rows[0] + np.arange(rows[1])) % n
    ci = (cols[0] + np.arange(cols[1])) % n
    mats = tuple(np.ascontiguousarray(m[np.ix_(ri, ci)])
                 for m in c2c_mats(n, sign, scale, NP_REAL[dtype]))
    sign = BACKWARD if sign == BACKWARD else FORWARD
    return DftMats(*device_mats(mats, device, dtype), n=n, sign=sign,
                   scale=scale, rows=rows, cols=cols,
                   twiddles=_twiddles(n, sign, fft_factors(n), device,
                                      dtype))


def _device_real(kind: str, n: int, scale: float, win, device,
                 dtype) -> DftMats:
    n, scale = int(n), float(scale)
    xf = n // 2 + 1
    win = _window(win, xf, f"device_{kind}")
    idx = tuple(int(i) for i in (win[0] + np.arange(win[1])) % xf)
    real = NP_REAL[dtype]
    if kind == "r2c":
        mats, sign = sub_cols_r2c_mats(n, idx, scale, real), FORWARD
        rows, cols = (0, n), win
    else:
        mats, sign = sub_rows_c2r_mats(n, idx, scale, real), BACKWARD
        rows, cols = win, (0, n)
    return DftMats(*device_mats(mats, device, dtype), n=n, sign=sign,
                   scale=scale, rows=rows, cols=cols,
                   twiddles=_twiddles(n, sign, rfft_factors(n), device,
                                      dtype),
                   kind=kind)


def device_r2c(n: int, scale: float = 1.0, cols=None,
               device="cpu", dtype=torch.float32) -> DftMats:
    """The forward real DFT of length ``n`` to the half spectrum, as
    :class:`DftMats` of kind ``"r2c"`` and ``dtype`` on ``device``:
    :func:`r2c_mats`, or with ``cols = (x0, w)`` the columns of bins
    ``(x0 + arange(w)) % (n // 2 + 1)`` (:func:`sub_cols_r2c_mats`), bit
    for bit; its table is ``fft_twiddles(n, FORWARD)`` where
    :func:`rfft_factors` has a list."""
    return _device_real("r2c", n, scale, cols, device, dtype)


def device_c2r(n: int, scale: float = 1.0, rows=None,
               device="cpu", dtype=torch.float32) -> DftMats:
    """The inverse real DFT of length ``n`` from the half spectrum, as
    :class:`DftMats` of kind ``"c2r"`` and ``dtype`` on ``device``:
    :func:`c2r_mats`, or with ``rows = (x0, w)`` the rows of bins
    ``(x0 + arange(w)) % (n // 2 + 1)`` (:func:`sub_rows_c2r_mats`), bit
    for bit; its table is ``fft_twiddles(n, BACKWARD)`` where
    :func:`rfft_factors` has a list."""
    return _device_real("c2r", n, scale, rows, device, dtype)


@functools.lru_cache(maxsize=1024)
def two_stage_factor(n: int):
    """The balanced factorization ``(n1, n2)`` of ``n`` with both
    factors <= ``MATMUL_DFT_MAX``, or None (the JAX package's two-stage
    routing rule, kept for :func:`mdft_coverable`)."""
    if n <= MATMUL_DFT_MAX:
        return None
    for n1 in range(math.isqrt(n), 1, -1):
        if n % n1 == 0:
            n2 = n // n1
            if n1 <= MATMUL_DFT_MAX and n2 <= MATMUL_DFT_MAX:
                return n1, n2
            return None
    return None


def _mdft_covered_len(n: int) -> bool:
    return (n <= MATMUL_DFT_DIRECT_FALLBACK_MAX
            or two_stage_factor(n) is not None)


def mdft_coverable(dims, hermitian: bool = False) -> bool:
    """Could these axes run the matmul-DFT forms of the JAX package at
    all (direct or two-stage; a hermitian x-axis direct only)? The
    precision model's calibration domain, independent of this slice."""
    ok = all(_mdft_covered_len(d) for d in dims)
    return ok and (not hermitian
                   or dims[0] <= MATMUL_DFT_DIRECT_FALLBACK_MAX)


def mdft_axes(*dims) -> bool:
    """The routing predicate of this slice: every axis runs the direct
    matmul form."""
    return all(1 <= int(d) <= MATMUL_DFT_MAX for d in dims)


# -- plain planar complex DFT ------------------------------------------------

def pdft_last(xr: torch.Tensor, xi: torch.Tensor, mats):
    """Complex DFT along the minor axis on planar operands:
    ``(..., K) -> (..., N)`` against ``(K, N)`` matrices.

    The plain 4-product form: Yr = Xr Cr - Xi Ci, Yi = Xr Ci + Xi Cr. It
    loses less in f32 than the JAX package's Karatsuba form, whose
    imaginary part is a difference of three sums, and so leaves more
    room under the accuracy contract. Raises
    :class:`~spfft_tpu_torch.errors.DeviceError` where ``torch.matmul``
    is set to a reduced float32 precision (see :func:`pirdft_last`)."""
    _require_fp32_matmul(xr, "pdft_last")
    cr, ci = mats
    return (torch.matmul(xr, cr) - torch.matmul(xi, ci),
            torch.matmul(xr, ci) + torch.matmul(xi, cr))


def pdft2_minor(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """[minor DFT (mats1), swap of the two minor axes, minor DFT
    (mats2)] on planar ``(P, A, B)`` operands -> ``(P, B', A')``."""
    gr, gi = pdft_last(xr, xi, mats1)
    return pdft_last(gr.transpose(-1, -2), gi.transpose(-1, -2), mats2)


def cdft2_xy(xr: torch.Tensor, xi: torch.Tensor, mats_minor, mats_mid):
    """[minor DFT (``mats_minor``), mid DFT (``mats_mid``)] on planar
    ``(P, A, B)`` operands -> ``(P, A', B')``, contiguous: the
    distributed xy stage (``spfft_tpu.ops.dft.cdft2_xy`` on a planar
    pair), as :func:`pdft2_minor` followed by a swap of the two minor
    axes."""
    yr, yi = pdft2_minor(xr, xi, mats_minor, mats_mid)
    return (yr.transpose(-1, -2).contiguous(),
            yi.transpose(-1, -2).contiguous())


# -- plain real transforms ----------------------------------------------------

def reduced_fp32_matmul(device: torch.device):
    """The reduced precision ``torch.matmul`` is set to use for float32
    operands on ``device``'s backend (``"tf32"`` for cuBLAS; ``"tf32"``
    or ``"bf16"`` for oneDNN on the CPU), or None when it computes in
    full FP32. Reads the process-wide settings of either PyTorch API
    (``fp32_precision`` or the older ``allow_tf32``)."""
    backend = torch.backends.cuda if device.type == "cuda" \
        else getattr(torch.backends, "mkldnn", None)
    mode = getattr(getattr(backend, "matmul", None), "fp32_precision", None)
    if mode is None:
        if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            return "tf32"
        return None
    return None if mode in ("ieee", "none") else mode


def _require_fp32_matmul(t: torch.Tensor, name: str) -> None:
    """Raise where ``t`` is float32 and ``torch.matmul`` computes float32
    products in a reduced precision; float64 products are never
    reduced."""
    if t.dtype != torch.float32:
        return
    mode = reduced_fp32_matmul(t.device)
    if mode is not None:
        raise DeviceError(
            f"{name}: torch.matmul is set to compute float32 products in "
            f"{mode} on {t.device.type} (a process-wide PyTorch setting), "
            f"which breaks the single-precision accuracy contract; set "
            f"torch.backends.{'cuda' if t.device.type == 'cuda' else 'mkldnn'}"
            f".matmul.fp32_precision = 'ieee'")


def prdft_last(x: torch.Tensor, mats):
    """Real forward DFT along the minor axis -> planar half spectrum:
    ``(..., n) -> (..., N)`` against :func:`r2c_mats` ``(n, N)``. Raises
    :class:`~spfft_tpu_torch.errors.DeviceError` where ``torch.matmul``
    is set to a reduced float32 precision (see :func:`pirdft_last`)."""
    _require_fp32_matmul(x, "prdft_last")
    a, b = mats
    return torch.matmul(x, a), torch.matmul(x, b)


def pirdft_last(yr: torch.Tensor, yi: torch.Tensor, mats):
    """Planar half spectrum -> real inverse along the minor axis:
    ``(..., K) -> (..., n)`` against :func:`c2r_mats` ``(K, n)``.

    This and :func:`prdft_last` are the plain versions of
    ``ops.dft_kernel.pirdft_last`` / ``prdft_last`` (the distributed R2C
    plan's x stage, which the JAX package runs outside any kernel), and
    what those run on a CPU tensor: ``torch.matmul``, which holds the
    precision contract only in full FP32. Both read the process-wide
    matmul precision (:func:`reduced_fp32_matmul`) and raise
    :class:`~spfft_tpu_torch.errors.DeviceError` when TF32 (or bf16 on
    the CPU) is on, rather than return errors near 1e-3."""
    _require_fp32_matmul(yr, "pirdft_last")
    a, b = mats
    return torch.matmul(yr, a) + torch.matmul(yi, b)


def prdft2_minor(x: torch.Tensor, mats1, mats2):
    """R2C head twin of :func:`pdft2_minor`: real ``(P, A, B)``, a real
    DFT over B (``mats1`` from :func:`r2c_mats`), swap, a complex DFT
    over A -> planar ``(P, B', A')``."""
    gr, gi = prdft_last(x, mats1)
    return pdft_last(gr.transpose(-1, -2), gi.transpose(-1, -2), mats2)


def pdft2_minor_cr(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """C2R tail twin of :func:`pdft2_minor`: planar ``(P, A, B)``, a
    complex DFT over B, swap, a real inverse DFT over A (``mats2`` from
    :func:`c2r_mats`) -> real ``(P, B', A')``."""
    gr, gi = pdft_last(xr, xi, mats1)
    return pirdft_last(gr.transpose(-1, -2), gi.transpose(-1, -2), mats2)
