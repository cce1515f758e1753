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

Forms by length. Every length the JAX package plans is planned here,
routed by its length alone at plan time (:func:`c2c_form`,
:func:`real_form`): a complex axis up to :data:`MATMUL_DFT_MAX` of the
form 2^a 3^b 5^c 7^d 11^e takes the FFT form (:func:`fft_factors`), an
even real axis up to :data:`MATMUL_DFT_DIRECT_FALLBACK_MAX` whose half
has that form the real FFT form (:func:`rfft_factors`); a complex axis
above :data:`MATMUL_DFT_MAX` with a balanced split n = n1 n2
(:func:`two_stage_factor`) takes the two-pass form, whose
:class:`DftMats` holds no dense n x n pair, only the length-n twiddle
table and the small tables of its plain version (the two-stage product,
:class:`TwoStageMats`); every other complex axis up to
:data:`MATMUL_DFT_DIRECT_FALLBACK_MAX` (a prime of 13 or more, and no
split), and every other real axis up to it (odd, or a half with such a
prime), Bluestein's chirp-z FFT (form ``"bluestein"``: no dense pair
either, only the chirp, the convolution's spectrum and its twiddles,
:class:`BluesteinTables`; plain version :func:`bluestein_plain`);
anything else ``torch.fft`` (form ``"library"``: the counterpart of the
JAX package's ``jnp.fft`` path, which is XLA, not Pallas). Those two are
the one routing rule: :func:`mdft_coverable` (the JAX package's
structural predicate, which the precision model reads) is derived from
them. The matrix form (a dense n x n product) runs only for a plain
matrix pair passed without its function and for the fused z kernels at a
dim_z the FFT form does not take (``device_c2c(form="matrix")``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..errors import DeviceError, InvalidParameterError

#: Longest axis of the direct matmul-DFT form, and of each pass of the
#: two-pass form.
MATMUL_DFT_MAX = 512

#: Longest unfactorable complex axis of the Bluestein form, and the
#: longest real axis of the Bluestein and real FFT forms; longer such axes
#: run ``torch.fft`` (form ``"library"``).
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


def _require_matrix(n: int, real: bool = False) -> None:
    """Raise where a length-``n`` axis has no dense matrix pair: a complex
    axis of the two-pass form (its :class:`TwoStageMats`) and any axis of
    the ``torch.fft`` form."""
    form = real_form(n) if real else c2c_form(n)
    if form in ("two_pass", "library"):
        raise InvalidParameterError(
            f"axis length {n} has no dense DFT matrix pair: it runs the "
            f"{'two-pass' if form == 'two_pass' else 'torch.fft'} form "
            f"(ops.dft.{'real_form' if real else 'c2c_form'})")


def c2c_mats(n: int, sign: int, scale: float = 1.0, dtype=np.float32):
    """Matrices ``(cr, ci)``, each ``(n, n)`` of numpy ``dtype``, for a
    complex length-``n`` DFT with ``scale`` folded in. ``sign=BACKWARD``
    with ``scale=1`` is the library's unnormalised inverse (ifft * n).
    A length above :data:`MATMUL_DFT_MAX` with a split returns its
    :class:`TwoStageMats` instead, as the JAX package's ``c2c_mats``
    does; one with neither a split nor a direct form raises."""
    n = int(n)
    s = +1 if sign == BACKWARD else -1
    if n > MATMUL_DFT_MAX and two_stage_factor(n) is not None:
        return _two_stage_mats(n, s, float(scale), np.dtype(dtype).type)
    _require_matrix(n)
    return _build_dft_mats(n, s, float(scale), np.dtype(dtype).type)


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
    dim_x_freq = n//2+1 — src/parameters/parameters.cpp:49), for n up to
    :data:`MATMUL_DFT_DIRECT_FALLBACK_MAX`."""
    _require_matrix(int(n), real=True)
    return _rdft_mats(int(n), float(scale), np.dtype(dtype).type)


def c2r_mats(n: int, scale: float = 1.0, dtype=np.float32):
    """Matrices ``(a, b)``, each ``(n//2+1, n)`` of numpy ``dtype``, of
    the unnormalised inverse real DFT from the half spectrum (irfft *
    n), for n up to :data:`MATMUL_DFT_DIRECT_FALLBACK_MAX`."""
    _require_matrix(int(n), real=True)
    return _irdft_mats(int(n), float(scale), np.dtype(dtype).type)


@functools.lru_cache(maxsize=32)
def sub_rows_mats(n: int, sign: int, rows: tuple, scale: float = 1.0,
                  dtype=np.float32):
    """Row-selected complex DFT matrices ``(len(rows), n)``: the split-x
    contraction from the occupied positions only (wrapped windows are
    non-contiguous row selections)."""
    _require_matrix(int(n))
    idx = np.asarray(rows)
    return tuple(np.ascontiguousarray(m[idx])
                 for m in c2c_mats(n, sign, scale, dtype))


@functools.lru_cache(maxsize=32)
def sub_cols_mats(n: int, sign: int, cols: tuple, scale: float = 1.0,
                  dtype=np.float32):
    """Column-selected complex DFT matrices ``(n, len(cols))``: produce
    only the occupied output positions."""
    _require_matrix(int(n))
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
    5s, 7s, 11s), or None where ``n`` has another prime factor (13 or
    more) or exceeds :data:`MATMUL_DFT_MAX`. ``()`` for n = 1."""
    if not 1 <= n <= MATMUL_DFT_MAX:
        return None
    out, rest = [], n
    for p in (4, 2, 3, 5, 7, 11):
        while rest % p == 0:
            out.append(p)
            rest //= p
    return tuple(out) if rest == 1 else None


#: bits of one stage's radix in :func:`radix_code` (11 needs 4; a factor
#: list up to 512 has at most 6 stages, 24 bits)
RADIX_BITS = 4


def radix_code(factors) -> int:
    """``factors`` packed :data:`RADIX_BITS` bits each, the first stage
    lowest: the ``radices`` argument of ``csrc/fft.cu`` (decoded in
    ``csrc/fft_tile.cuh``: fft_rows_inline); 0 for None (the direct DFT
    of a two-pass factor with another prime, ``csrc/fft_long.cu``)."""
    return sum(p << (RADIX_BITS * i) for i, p in enumerate(factors or ()))


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
    or None where ``n`` is odd or its half has a prime factor of 13 or
    more."""
    return fft_factors(n // 2) if n >= 2 and n % 2 == 0 else None


# -- routing by length --------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def two_stage_factor(n: int):
    """The balanced factorization ``(n1, n2)`` of ``n`` with ``n1 * n2 ==
    n``, both factors <= ``MATMUL_DFT_MAX`` and ``n1 + n2`` minimal, or
    None where ``n`` fits the direct form or has no such split (the JAX
    package's ``two_stage_factor``)."""
    if n <= MATMUL_DFT_MAX:
        return None
    for n1 in range(math.isqrt(n), 1, -1):
        if n % n1 == 0:
            n2 = n // n1
            if n1 <= MATMUL_DFT_MAX and n2 <= MATMUL_DFT_MAX:
                return n1, n2
            return None  # n2 only grows as n1 shrinks
    return None


def mdft_coverable(dims, hermitian: bool = False) -> bool:
    """Could these axes run the matrix forms at all (any form but
    ``torch.fft``; a hermitian x axis, ``dims[0]``, a real form)? The JAX
    package's structural routing answer, which the precision model
    reads."""
    ok = all(c2c_form(d) != "library" for d in dims)
    return ok and (not hermitian or real_form(dims[0]) != "library")


def c2c_form(n: int) -> str:
    """The form of a complex length-``n`` stage, by length alone:
    ``"fft"`` (n <= 512 of the form 2^a 3^b 5^c 7^d 11^e),
    ``"two_pass"`` (n > 512 with :func:`two_stage_factor`),
    ``"bluestein"`` (any other n <= 1024: a prime of 13 or more up to
    512, an unsplittable length above) or ``"library"``. No short length
    keeps the matrix form: on an H100 (700 W) Bluestein ran 3.2-3.5x
    faster than it at 13, 26 and 52 (``chip_smoke.py``'s Bluestein
    records, 2^25 elements a call)."""
    n = int(n)
    if fft_factors(n) is not None:
        return "fft"
    if n > MATMUL_DFT_MAX and two_stage_factor(n) is not None:
        return "two_pass"
    return "bluestein" if n <= MATMUL_DFT_DIRECT_FALLBACK_MAX \
        else "library"


def real_form(n: int) -> str:
    """The form of a real length-``n`` stage (R2C or C2R): ``"rfft"``
    (even n <= 1024 whose half is 2^a 3^b 5^c 7^d 11^e), ``"bluestein"``
    (any other n <= 1024: odd, or a half with a prime of 13 or more) or
    ``"library"``."""
    n = int(n)
    if n > MATMUL_DFT_DIRECT_FALLBACK_MAX:
        return "library"
    return "rfft" if rfft_factors(n) is not None else "bluestein"


class TwoStageMats(tuple):
    """Numpy tables of the two-stage Cooley-Tukey DFT of length ``n = n1 *
    n2`` (the JAX package's ``TwoStageMats``), in one real type: the
    factors' matrix pairs ``mats1`` ``(n1, n1)`` and ``mats2`` ``(n2,
    n2)`` (the caller's scale folded into ``mats2``) and the twiddle grid
    ``(tr, ti)`` ``(n2, n1)``, ``W_n^(i2 k1)`` computed in float64 and
    rounded once. It unpacks as ``(mats1, mats2, (tr, ti))``."""

    def __new__(cls, n1, n2, mats1, mats2, tr, ti):
        self = super().__new__(cls, (mats1, mats2, (tr, ti)))
        self.n1, self.n2 = n1, n2
        self.mats1, self.mats2, self.tr, self.ti = mats1, mats2, tr, ti
        return self


@functools.lru_cache(maxsize=32)
def _two_stage_mats(n: int, s: int, scale: float, dtype=np.float32):
    n1, n2 = two_stage_factor(n)
    w = fft_twiddles(n, BACKWARD if s > 0 else FORWARD)[
        np.outer(np.arange(n2), np.arange(n1))]
    return TwoStageMats(n1, n2, _build_dft_mats(n1, s, 1.0, dtype),
                        _build_dft_mats(n2, s, scale, dtype),
                        np.ascontiguousarray(w.real.astype(dtype)),
                        np.ascontiguousarray(w.imag.astype(dtype)))


#: the longest factor one thread of the Bluestein kernel holds in
#: registers, and the longest (even) one a float lane pair holds: the plan
#: time's copy of csrc/fft_reg.cuh's has_plan (plans are made without a
#: card); the wrapper holds each float M to the library's own rule
#: (``dft_kernel.reg_plan``)
REG_ROW_MAX, REG_PAIR_MAX = 32, 64


@functools.lru_cache(maxsize=1024)
def bluestein_length(n: int) -> int:
    """The length M of the Bluestein form's circular convolution: the
    smallest 2^a 3^b 5^c >= 2 n - 1 whose :func:`bluestein_split` has
    factors that run in registers in float (each at least 2 and at most
    :data:`REG_ROW_MAX`, or even and at most :data:`REG_PAIR_MAX`), and
    for n up to :data:`MATMUL_DFT_MAX` (the lengths the fused z kernels
    take too) factors of at most :data:`REG_ROW_MAX`, neither a multiple
    of 27: 25 = 5 x 5 for 13, 200 = 10 x 20 for 100, 576 = 24 x 24 for
    257, 900 = 30 x 30 for 416, 1024 = 32 x 32 for 491 and 509, 1080 = 30
    x 36 for 521 and 520, 2000 = 40 x 50 for 997, 2048 = 32 x 64 for 1021
    and 1022 (1125 = 25 x 45 and 2025 = 45 x 45 give way to 1152 and 2048;
    1 and 5 = 1 x 5 to 4 and 6). A factor of 27 runs three radix-3 stages,
    the least accurate factor FFT in float: with 864 = 27 x 32 at 416, a
    416^3 C2C pair (all three axes in this form) missed its accuracy
    contract on an H100 (``chip_smoke.py``'s prime path), which 900 keeps,
    for 4 % more of the convolution's work; the lengths this rule moves
    up to 512 take at most 11 % more."""
    n = int(n)
    m = max(1, 2 * n - 1)
    while True:
        rest = m
        for p in (2, 3, 5):
            while rest % p == 0:
                rest //= p
        split = bluestein_split(m)
        if rest == 1 and all(2 <= f <= REG_ROW_MAX or (
                f <= REG_PAIR_MAX and f % 2 == 0) for f in split) and (
                n > MATMUL_DFT_MAX or all(
                    f <= REG_ROW_MAX and f % 27 for f in split)):
            return m
        m += 1


@functools.lru_cache(maxsize=1024)
def bluestein_split(m: int) -> tuple:
    """``(m1, m2)``, ``m1 * m2 == m``, the factors of the Bluestein
    kernel's four-step FFT of length ``m``: the balanced split, m1 the
    largest divisor of ``m`` up to sqrt(m) (5 x 5 for 25, 10 x 20 for
    200, 30 x 36 for 1080, 32 x 64 for 2048: :func:`two_stage_factor`
    wherever that has a split), so that the larger factor is as small as
    ``m`` allows: a double M whose factors can both be at most 32 runs
    both in registers. ``(1, m)`` for m = 1 and a prime m."""
    for m1 in range(math.isqrt(m), 0, -1):
        if m % m1 == 0:
            return m1, m // m1
    return 1, m


class BluesteinTables(tuple):
    """The tables of the Bluestein form of a length-``n`` DFT, in one real
    type, each ``(2, len)`` (real row, imaginary row), computed in float64
    and rounded once: ``chirp`` w[j] = e^(sign i pi j^2 / n) (j^2 reduced
    mod 2n) of length n; ``spectrum`` B = FFT_M(h) / M times the caller's
    scale, h the length-M wrap of conj(w) (h[d] = h[M - d] = conj(w[d]), 0
    between); ``twiddles`` e^(-2 pi i m / M), the forward table of both
    length-M FFTs. ``m`` is M (:func:`bluestein_length`), ``split`` its
    (m1, m2). It unpacks as ``(chirp, spectrum, twiddles)``."""

    def __new__(cls, m, chirp, spectrum, twiddles):
        self = super().__new__(cls, (chirp, spectrum, twiddles))
        self.m, self.split = m, bluestein_split(m)
        self.chirp, self.spectrum, self.twiddles = chirp, spectrum, twiddles
        return self


@functools.lru_cache(maxsize=64)
def _bluestein_tables(n: int, sign: int, scale: float, dtype=np.float32):
    """Numpy :class:`BluesteinTables` of the length-``n`` DFT of ``sign``
    with ``scale`` folded into the spectrum, rounded once to ``dtype``."""
    m = bluestein_length(n)
    j = np.arange(n, dtype=np.int64)
    w = np.exp((1 if sign == BACKWARD else -1) * 1j * np.pi
               * ((j * j) % (2 * n)) / n)
    h = np.zeros(m, np.complex128)
    h[:n] = np.conj(w)
    h[m - n + 1:] = np.conj(w[1:][::-1])
    spec = np.fft.fft(h) * (scale / m)

    def planes(z):
        return np.ascontiguousarray(np.stack([z.real, z.imag]).astype(dtype))

    return BluesteinTables(m, planes(w), planes(spec),
                           planes(fft_twiddles(m, FORWARD)))


class DftMats(tuple):
    """A DFT stage's tables, carrying the function they stand for, so a
    kernel can compute it in its form: the ``kind`` (``"c2c"``; ``"r2c"``
    / ``"c2r"``, the real transforms of :func:`r2c_mats` /
    :func:`c2r_mats`), the length ``n``, ``sign``, ``scale``, the input
    window ``rows = (x0, w)`` (input k is position ``(x0 + k) % L``) and
    the output window ``cols = (y0, w)`` (output j is position ``(y0 + j)
    % L``), where L is ``n`` on a complex axis and ``n // 2 + 1`` on a
    half spectrum (the input of c2r, the output of r2c), the ``form``
    (:func:`c2c_form` / :func:`real_form`; where not given, the FFT or
    real FFT form for a pair with a table, else ``"matrix"``) and
    ``twiddles``, the device table ``(2,
    n)`` in the tables' dtype (real row, imaginary row of
    :func:`fft_twiddles`) of the FFT, real FFT and two-pass forms, else
    None. The matrix forms unpack as their pair (``cr, ci = mats``); the
    two-pass, Bluestein and ``torch.fft`` forms hold no pair (an empty
    tuple); a two-pass one carries ``plain``, the device tables of its
    plain version (:class:`TwoStageMats`), a Bluestein one ``bluestein``,
    its device :class:`BluesteinTables`. :attr:`shape` is ``(K, N)``, the
    stage's input and output widths."""

    def __new__(cls, cr, ci, *, n, sign, scale, rows, cols, twiddles,
                kind="c2c", form=None, plain=None, bluestein=None):
        self = super().__new__(cls, () if cr is None else (cr, ci))
        if form is None:  # a pair with its table has its FFT form
            form = "matrix" if twiddles is None \
                else "fft" if kind == "c2c" else "rfft"
        self.n, self.sign, self.scale = n, sign, scale
        self.rows, self.cols, self.twiddles = rows, cols, twiddles
        self.kind, self.form, self.plain = kind, form, plain
        self.bluestein = bluestein
        return self

    @property
    def shape(self) -> tuple:
        return (self.rows[1], self.cols[1])

    @property
    def factors(self):
        """The FFT form's stage radices: :func:`fft_factors` of ``n``, or
        for a real kind :func:`rfft_factors`."""
        return fft_factors(self.n) if self.kind == "c2c" \
            else rfft_factors(self.n)

    @property
    def split(self):
        """The two-pass form's ``(n1, n2)``, or None."""
        return two_stage_factor(self.n) if self.form == "two_pass" else None

    @property
    def tensors(self) -> tuple:
        """Every device tensor the stage holds."""
        out = tuple(self)
        if self.twiddles is not None:
            out += (self.twiddles,)
        if self.plain is not None:
            out += (*self.plain.mats1, *self.plain.mats2, self.plain.tr,
                    self.plain.ti)
        if self.bluestein is not None:
            out += tuple(self.bluestein)
        return out


def mats_shape(mats) -> tuple:
    """``(K, N)`` of a stage's tables: :attr:`DftMats.shape`, or a plain
    pair's matrix shape."""
    if isinstance(mats, DftMats):
        return mats.shape
    return tuple(mats[0].shape)


def _window(win, length: int, what: str) -> tuple:
    """``win = (x0, w)`` with ``x0`` taken modulo ``length`` (the whole
    axis where None); raises where ``w`` exceeds ``length``."""
    win = (0, length) if win is None else (int(win[0]) % length, int(win[1]))
    if not 0 <= win[1] <= length:
        raise InvalidParameterError(
            f"{what}: window {win} must lie within the length {length}")
    return win


def device_bluestein(n: int, sign: int, scale: float, device,
                     dtype) -> BluesteinTables:
    """The :class:`BluesteinTables` of a length-``n`` DFT as tensors of
    ``dtype`` on ``device``."""
    t = _bluestein_tables(int(n), sign, float(scale), NP_REAL[dtype])
    return BluesteinTables(t.m, *(torch.as_tensor(a, device=device)
                                  for a in t))


def _twiddles(n: int, sign: int, device, dtype):
    t = fft_twiddles(n, sign)
    return torch.as_tensor(np.stack([t.real, t.imag]).astype(NP_REAL[dtype]),
                           device=device)


def device_c2c(n: int, sign: int, scale: float = 1.0, rows=None, cols=None,
               device="cpu", dtype=torch.float32, form=None) -> DftMats:
    """The length-``n`` complex DFT with ``scale`` folded in, as
    :class:`DftMats` of ``dtype`` (float32 or float64) on ``device``, in
    the form :func:`c2c_form` gives its length, or ``form="matrix"`` (the
    dense product against the matrix pair, which no plan builds; n up
    to :data:`MATMUL_DFT_MAX`): the FFT and matrix forms carry
    :func:`c2c_mats`, or with ``rows = (x0, w)`` the window's rows
    (:func:`sub_rows_mats` of ``(x0 + arange(w)) % n``), with ``cols =
    (y0, w)`` the window's columns (:func:`sub_cols_mats`), bit for bit;
    the two-pass form the length-n table and its plain version's
    :class:`TwoStageMats`; the Bluestein form its
    :class:`BluesteinTables`; the ``torch.fft`` form nothing."""
    n, scale = int(n), float(scale)
    rows = _window(rows, n, "device_c2c")
    cols = _window(cols, n, "device_c2c")
    sign = BACKWARD if sign == BACKWARD else FORWARD
    if form is None:
        form = c2c_form(n)
    elif form != "matrix" or n > MATMUL_DFT_MAX:
        raise InvalidParameterError(
            f"device_c2c: form {form!r} at length {n}: a length takes its "
            f"own form (c2c_form) or the matrix form up to {MATMUL_DFT_MAX}")
    spec = dict(n=n, sign=sign, scale=scale, rows=rows, cols=cols,
                form=form)
    if form == "library":
        return DftMats(None, None, twiddles=None, **spec)
    if form == "bluestein":
        return DftMats(None, None, twiddles=None, bluestein=device_bluestein(
            n, sign, scale, device, dtype), **spec)
    tw = _twiddles(n, sign, device, dtype) \
        if form in ("fft", "two_pass") else None
    if form == "two_pass":
        ts = c2c_mats(n, sign, scale, NP_REAL[dtype])
        plain = TwoStageMats(ts.n1, ts.n2, device_mats(ts.mats1, device,
                                                       dtype),
                             device_mats(ts.mats2, device, dtype),
                             *device_mats((ts.tr, ts.ti), device, dtype))
        return DftMats(None, None, twiddles=tw, plain=plain, **spec)
    ri = (rows[0] + np.arange(rows[1])) % n
    ci = (cols[0] + np.arange(cols[1])) % n
    mats = tuple(np.ascontiguousarray(m[np.ix_(ri, ci)])
                 for m in c2c_mats(n, sign, scale, NP_REAL[dtype]))
    return DftMats(*device_mats(mats, device, dtype), twiddles=tw, **spec)


def _device_real(kind: str, n: int, scale: float, win, device,
                 dtype) -> DftMats:
    n, scale = int(n), float(scale)
    xf = n // 2 + 1
    win = _window(win, xf, f"device_{kind}")
    if kind == "r2c":
        sign, rows, cols = FORWARD, (0, n), win
    else:
        sign, rows, cols = BACKWARD, win, (0, n)
    form = real_form(n)
    spec = dict(n=n, sign=sign, scale=scale, rows=rows, cols=cols,
                kind=kind, form=form)
    if form == "library":
        return DftMats(None, None, twiddles=None, **spec)
    if form == "bluestein":
        return DftMats(None, None, twiddles=None, bluestein=device_bluestein(
            n, sign, scale, device, dtype), **spec)
    idx = tuple(int(i) for i in (win[0] + np.arange(win[1])) % xf)
    real = NP_REAL[dtype]
    mats = sub_cols_r2c_mats(n, idx, scale, real) if kind == "r2c" \
        else sub_rows_c2r_mats(n, idx, scale, real)
    return DftMats(*device_mats(mats, device, dtype),
                   twiddles=_twiddles(n, sign, device, dtype)
                   if form == "rfft" else None, **spec)


def device_r2c(n: int, scale: float = 1.0, cols=None,
               device="cpu", dtype=torch.float32) -> DftMats:
    """The forward real DFT of length ``n`` to the half spectrum, as
    :class:`DftMats` of kind ``"r2c"`` and ``dtype`` on ``device`` in the
    form :func:`real_form` gives its length: in the matrix and real FFT
    forms :func:`r2c_mats`, or with ``cols = (x0, w)`` the columns of
    bins ``(x0 + arange(w)) % (n // 2 + 1)`` (:func:`sub_cols_r2c_mats`),
    bit for bit, and in the real FFT form the table ``fft_twiddles(n,
    FORWARD)``; in the Bluestein form its :class:`BluesteinTables`; above
    :data:`MATMUL_DFT_DIRECT_FALLBACK_MAX` no tables
    (``torch.fft.rfft``)."""
    return _device_real("r2c", n, scale, cols, device, dtype)


def device_c2r(n: int, scale: float = 1.0, rows=None,
               device="cpu", dtype=torch.float32) -> DftMats:
    """The inverse real DFT of length ``n`` from the half spectrum, as
    :class:`DftMats` of kind ``"c2r"`` and ``dtype`` on ``device`` in the
    form :func:`real_form` gives its length: in the matrix and real FFT
    forms :func:`c2r_mats`, or with ``rows = (x0, w)`` the rows of bins
    ``(x0 + arange(w)) % (n // 2 + 1)`` (:func:`sub_rows_c2r_mats`), bit
    for bit, and in the real FFT form the table ``fft_twiddles(n,
    BACKWARD)``; in the Bluestein form its :class:`BluesteinTables`;
    above the fallback cap no tables (``torch.fft.irfft``)."""
    return _device_real("c2r", n, scale, rows, device, dtype)


# -- windows of the forms that run whole axes --------------------------------

def _window_index(win, length: int, device) -> torch.Tensor:
    return (win[0] + torch.arange(win[1], device=device)) % length


def expand_window(x: torch.Tensor, win, length: int) -> torch.Tensor:
    """Rows ``(..., w)`` holding positions ``(x0 + k) % length`` of a
    window ``win = (x0, w)`` -> whole rows ``(..., length)``, zero
    elsewhere (the JAX package's ``_expand_x_window``); ``x`` itself
    where the window is the whole axis."""
    if tuple(win) == (0, length):
        return x
    out = x.new_zeros(x.shape[:-1] + (length,))
    out[..., _window_index(win, length, x.device)] = x
    return out


def extract_window(y: torch.Tensor, win, length: int) -> torch.Tensor:
    """The window ``win`` of whole rows ``(..., length)`` (the JAX
    package's ``_extract_x_window``), contiguous; ``y`` itself where the
    window is the whole axis."""
    if tuple(win) == (0, length):
        return y
    return y[..., _window_index(win, length, y.device)].contiguous()


# -- plain planar complex DFT ------------------------------------------------

def pdft_last(xr: torch.Tensor, xi: torch.Tensor, mats):
    """Complex DFT along the minor axis on planar operands:
    ``(..., K) -> (..., N)`` against ``(K, N)`` tables.

    The matrix forms: the plain 4-product form, Yr = Xr Cr - Xi Ci, Yi =
    Xr Ci + Xi Cr. It loses less in f32 than the JAX package's Karatsuba
    form, whose imaginary part is a difference of three sums, and so
    leaves more room under the accuracy contract. The two-pass form: the
    two-stage product (:func:`two_pass_plain`); the Bluestein form:
    :func:`bluestein_plain`; the ``torch.fft`` form: :func:`library_c2c`.
    Raises
    :class:`~spfft_tpu_torch.errors.DeviceError` where ``torch.matmul``
    is set to a reduced float32 precision (see :func:`pirdft_last`)."""
    form = getattr(mats, "form", None)
    if form == "two_pass":
        return two_pass_plain(xr, xi, mats)
    if form == "bluestein":
        return bluestein_plain("cc", (xr, xi), mats)
    if form == "library":
        return library_c2c(xr, xi, mats)
    _require_fp32_matmul(xr, "pdft_last")
    return _pdft_dense(xr, xi, mats)


def _pdft_dense(xr, xi, mats):
    cr, ci = mats
    return (torch.matmul(xr, cr) - torch.matmul(xi, ci),
            torch.matmul(xr, ci) + torch.matmul(xi, cr))


def two_pass_plain(xr: torch.Tensor, xi: torch.Tensor, mats):
    """The two-stage Cooley-Tukey DFT of a two-pass :class:`DftMats` (the
    JAX package's ``_pdft_two_stage`` in the 4-product form): with n =
    i1 n2 + i2 and k = k2 n1 + k1, a DFT over i1 (``plain.mats1``), the
    twiddle ``W_n^(i2 k1)`` (``plain.tr``, ``plain.ti``), a DFT over i2
    (``plain.mats2``, the scale folded in), bins put in natural order;
    the input window expanded to the whole axis first and the output
    window taken out last. The plain version of the two-pass kernel
    (``csrc/fft_long.cu``)."""
    _require_fp32_matmul(xr, "pdft_last")
    n, ts = mats.n, mats.plain
    xr = expand_window(xr, mats.rows, n)
    xi = expand_window(xi, mats.rows, n)
    lead = tuple(xr.shape[:-1])
    view = lead + (ts.n1, ts.n2)
    ar, ai = _pdft_dense(xr.reshape(view).transpose(-1, -2),
                         xi.reshape(view).transpose(-1, -2), ts.mats1)
    br = ar * ts.tr - ai * ts.ti
    bi = ar * ts.ti + ai * ts.tr
    yr, yi = _pdft_dense(br.transpose(-1, -2), bi.transpose(-1, -2),
                         ts.mats2)
    yr = yr.transpose(-1, -2).reshape(lead + (n,))
    yi = yi.transpose(-1, -2).reshape(lead + (n,))
    return (extract_window(yr, mats.cols, n),
            extract_window(yi, mats.cols, n))


def bluestein_plain(mode: str, ins, mats):
    """The Bluestein form of a stage in ``mode`` (``"cc"``: planar
    complex rows ``ins = (xr, xi)``; ``"rc"``: real rows ``(x,)``;
    ``"cr"``: the planar half-spectrum window) against its
    :class:`DftMats`, as the Bluestein kernel (``csrc/bluestein.cu``)
    computes it, in the tables' real type: a[j] = x[j] w[j] on the input
    window (cr: bin k of the window times 1 for the self-conjugate bins,
    2 for the others, the upper half 0), zero-padded to M; the inverse of
    FFT_M(a) times the spectrum B (1/M and the scale in it, so the
    inverse is unnormalised); times w[k]; the output window (cr: the real
    part). Both length-M FFTs are ``torch.fft`` calls, computed in
    complex128 whatever the tables' type (the tables and the result keep
    it): this version, the CPU path of every Bluestein stage, adds one
    rounding to the tables', where the kernels' float32 FFT pair adds
    about twice a dense product's error at a short length (a difference
    kept on purpose, ROADMAP: the CPU tests hold float32 plans at dim_z 13
    to the JAX package's dense product within ``predicted_rel_error``;
    ``chip_smoke.py``'s ``prime_small_phase`` holds the card's float32
    kernels to the complex128 oracle there). Returns a pair of planes (cc,
    rc) or one real tensor (cr)."""
    n, bt = mats.n, mats.bluestein
    w = torch.complex(bt.chirp[0], bt.chirp[1])
    spec = torch.complex(bt.spectrum[0], bt.spectrum[1])
    xf = n // 2 + 1
    if mode == "rc":
        a = torch.complex(ins[0], torch.zeros_like(ins[0]))
    elif mode == "cc":
        a = torch.complex(expand_window(ins[0], mats.rows, n),
                          expand_window(ins[1], mats.rows, n))
    else:
        half = torch.complex(expand_window(ins[0], mats.rows, xf),
                             expand_window(ins[1], mats.rows, xf))
        c = torch.full((xf,), 2.0, dtype=ins[0].dtype, device=w.device)
        c[0] = 1.0
        if n % 2 == 0:
            c[xf - 1] = 1.0
        a = torch.zeros(half.shape[:-1] + (n,), dtype=half.dtype,
                        device=half.device)
        a[..., :xf] = half * c
    c128 = torch.complex128
    w = w.to(c128)
    conv = torch.fft.ifft(torch.fft.fft(a.to(c128) * w, n=bt.m)
                          * spec.to(c128), norm="forward")[..., :n]
    y = (conv * w).to(a.dtype)
    if mode == "cr":
        return y.real.contiguous()
    if mode == "rc":
        y = extract_window(y[..., :xf], mats.cols, xf)
    else:
        y = extract_window(y, mats.cols, n)
    return y.real.contiguous(), y.imag.contiguous()


def library_c2c(xr: torch.Tensor, xi: torch.Tensor, mats):
    """The ``torch.fft`` form of a complex stage: ``ifft`` unnormalised
    (backward) or ``fft`` (forward) of the whole axis, times the scale,
    with the input window expanded and the output window taken out."""
    n = mats.n
    z = torch.complex(expand_window(xr, mats.rows, n),
                      expand_window(xi, mats.rows, n))
    y = torch.fft.ifft(z, norm="forward") if mats.sign == BACKWARD \
        else torch.fft.fft(z)
    if mats.scale != 1.0:
        y = y * mats.scale
    y = extract_window(y, mats.cols, n)
    return y.real.contiguous(), y.imag.contiguous()


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
    ``(..., n) -> (..., N)`` against :func:`r2c_mats` ``(n, N)``, for the
    Bluestein form :func:`bluestein_plain`, or for the ``torch.fft`` form
    ``torch.fft.rfft`` times the scale, its output window taken out.
    Raises
    :class:`~spfft_tpu_torch.errors.DeviceError` where ``torch.matmul``
    is set to a reduced float32 precision (see :func:`pirdft_last`)."""
    if getattr(mats, "form", None) == "bluestein":
        return bluestein_plain("rc", (x,), mats)
    if getattr(mats, "form", None) == "library":
        y = torch.fft.rfft(x)
        if mats.scale != 1.0:
            y = y * mats.scale
        y = extract_window(y, mats.cols, mats.n // 2 + 1)
        return y.real.contiguous(), y.imag.contiguous()
    _require_fp32_matmul(x, "prdft_last")
    a, b = mats
    return torch.matmul(x, a), torch.matmul(x, b)


def pirdft_last(yr: torch.Tensor, yi: torch.Tensor, mats):
    """Planar half spectrum -> real inverse along the minor axis:
    ``(..., K) -> (..., n)`` against :func:`c2r_mats` ``(K, n)``, for the
    Bluestein form :func:`bluestein_plain`, or for the ``torch.fft`` form
    the input window expanded to the half
    spectrum, the imaginary parts of its self-conjugate bins dropped (as
    the matrices drop them) and ``torch.fft.irfft`` unnormalised times
    the scale.

    This and :func:`prdft_last` are the plain versions of
    ``ops.dft_kernel.pirdft_last`` / ``prdft_last`` (the distributed R2C
    plan's x stage, which the JAX package runs outside any kernel), and
    what those run on a CPU tensor: ``torch.matmul``, which holds the
    precision contract only in full FP32. Both read the process-wide
    matmul precision (:func:`reduced_fp32_matmul`) and raise
    :class:`~spfft_tpu_torch.errors.DeviceError` when TF32 (or bf16 on
    the CPU) is on, rather than return errors near 1e-3."""
    if getattr(mats, "form", None) == "bluestein":
        return bluestein_plain("cr", (yr, yi), mats)
    if getattr(mats, "form", None) == "library":
        n = mats.n
        xf = n // 2 + 1
        z = torch.complex(expand_window(yr, mats.rows, xf),
                          expand_window(yi, mats.rows, xf))
        z.imag[..., 0] = 0
        if n % 2 == 0:
            z.imag[..., xf - 1] = 0
        x = torch.fft.irfft(z, n=n, norm="forward")
        return x * mats.scale if mats.scale != 1.0 else x
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
