"""Index planning: sparse frequency triplets -> z-stick tables
(counterpart of ``spfft_tpu.indexing``).

Semantics of the reference index conversion (reference:
src/compression/indices.hpp:120-186 ``convert_index_triplets``, :49-55
``to_storage_index``, :105-117 ``check_stick_duplicates``). Everything
here runs once per plan on the host; the tables it produces are copied
to the device by the plan.

The conversion and the inverse maps take the native planner
(:mod:`.native.planner`, C++ built at first use) and keep the numpy
versions here as their specification. The numpy path also converts a
hermitian set that carries its redundant x < 0 half (folded first), and
any set where the caller asks for it (``native=False``) or the library is
unavailable; every :class:`IndexPlan` records which planner built it and,
for numpy, why (``planner``, ``planner_reason``).

Conventions (identical to the reference and the JAX package):

* A "z-stick" is the set of all sparse values sharing an (x, y) index
  pair; sticks are keyed by ``x * dim_y + y`` and ordered ascending.
* Each value maps to the flat index ``stick_id * dim_z + z`` into the
  packed stick array.
* Negative ("centered") indices map to storage via ``dim + index``;
  centered indexing is detected by any negative index.
* Bounds: for a dimension of size n, centered indices lie in
  [floor(n/2) - n + 1, floor(n/2)], non-negative ones in [0, n-1];
  hermitian (R2C) transforms also require x in [0, floor(n/2)] after
  folding the redundant x < 0 half.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .errors import (DuplicateIndicesError, InvalidIndicesError,
                     InvalidParameterError, OverflowError_)
from .types import TransformType


def to_storage_index(dim: int, index: np.ndarray) -> np.ndarray:
    """Map [-N, N) frequency indices to [0, N) storage indices
    (reference: indices.hpp:49-55)."""
    return np.where(index < 0, index + dim, index)


def _check_triplet_bounds(hermitian: bool, centered: bool,
                          dim_x: int, dim_y: int, dim_z: int,
                          x: np.ndarray, y: np.ndarray, z: np.ndarray) -> None:
    """Bounds validation, exactly as reference indices.hpp:137-149."""
    max_x = (dim_x // 2 + 1 if (hermitian or centered) else dim_x) - 1
    max_y = (dim_y // 2 + 1 if centered else dim_y) - 1
    max_z = (dim_z // 2 + 1 if centered else dim_z) - 1
    min_x = 0 if hermitian else max_x - dim_x + 1
    min_y = max_y - dim_y + 1
    min_z = max_z - dim_z + 1
    if ((x < min_x).any() or (x > max_x).any()
            or (y < min_y).any() or (y > max_y).any()
            or (z < min_z).any() or (z > max_z).any()):
        raise _oob(dim_x, dim_y, dim_z, hermitian, centered)


def canonicalize_hermitian_triplets(dim_x: int, dim_y: int, dim_z: int,
                                    x: np.ndarray, y: np.ndarray,
                                    z: np.ndarray):
    """Fold the redundant x < 0 half of a hermitian frequency set onto
    its conjugate-mirror triplets: F(-x,-y,-z) = conj(F(x,y,z)) for real
    fields. Returns ``(x, y, z, conj)`` with ``conj`` a boolean
    per-value mask, or None when nothing was folded. The mirror of the
    even-dimension edge +N/2 is normalised to -N/2 (the same storage
    index) so that the bounds check accepts it."""
    neg = x < 0
    if not neg.any():
        return x, y, z, None

    def mirror(v, dim):
        mv = np.where(neg, -v, v)
        return np.where(neg & (2 * v == dim), -(dim // 2), mv)

    return (np.where(neg, -x, x), mirror(y, dim_y), mirror(z, dim_z),
            neg)


def _oob(dim_x: int, dim_y: int, dim_z: int, hermitian: bool,
         centered: bool) -> InvalidIndicesError:
    return InvalidIndicesError(
        f"index triplet out of bounds for dims ({dim_x},{dim_y},{dim_z}), "
        f"hermitian={hermitian}, centered={centered}")


def _too_many() -> InvalidParameterError:
    return InvalidParameterError(
        "more frequency values than grid elements (indices.hpp:126-128)")


#: ``IndexPlan.planner_reason`` where the caller asked for numpy
NUMPY_ASKED = "native=False was asked for"
#: ... where a hermitian set carries its x < 0 half (folded in numpy)
NUMPY_FOLDED = "a hermitian set with x < 0 is folded on the numpy path"
#: ... where the plane is too large for the native dense bitmap
NUMPY_NO_NATIVE_PATH = "the plane is too large for the native bitmap"


def _convert(hermitian: bool, dim_x: int, dim_y: int, dim_z: int,
             triplets: np.ndarray, native: bool):
    """:func:`convert_index_triplets` and the planner that ran it:
    ``(value_indices, stick_keys, centered, conj, planner, reason)``."""
    triplets = np.asarray(triplets)
    if triplets.ndim != 2 or triplets.shape[1] != 3:
        raise InvalidParameterError(
            f"expected (n, 3) index triplets, got shape {triplets.shape}")
    if not np.issubdtype(triplets.dtype, np.integer):
        raise InvalidParameterError(
            f"index triplets must be integers, got dtype {triplets.dtype}")
    n = triplets.shape[0]
    if n > dim_x * dim_y * dim_z:
        raise _too_many()

    x = triplets[:, 0].astype(np.int64)
    folded = hermitian and bool((x < 0).any())
    reason = NUMPY_FOLDED if folded else NUMPY_ASKED
    if native and not folded:
        from .native import planner
        res = planner.plan_indices(hermitian, dim_x, dim_y, dim_z, triplets)
        if res is None:
            reason = planner.unavailable_reason()
        else:
            status, value_indices, stick_keys, centered = res
            if status == planner.ERR_INVALID_BOUNDS:
                raise _oob(dim_x, dim_y, dim_z, hermitian, centered)
            if status == planner.ERR_TOO_MANY_VALUES:
                raise _too_many()
            if status >= 0:
                return (value_indices, stick_keys, centered, None, "native",
                        None)
            reason = NUMPY_NO_NATIVE_PATH

    y, z = triplets[:, 1].astype(np.int64), triplets[:, 2].astype(np.int64)
    centered = bool((triplets < 0).any())
    conj = None
    if folded:
        x, y, z, conj = canonicalize_hermitian_triplets(
            dim_x, dim_y, dim_z, x, y, z)

    _check_triplet_bounds(hermitian, centered, dim_x, dim_y, dim_z, x, y, z)

    xs = to_storage_index(dim_x, x)
    ys = to_storage_index(dim_y, y)
    zs = to_storage_index(dim_z, z)

    keys = xs * dim_y + ys
    stick_keys, stick_ids = np.unique(keys, return_inverse=True)
    value_indices = stick_ids.astype(np.int64).reshape(-1) * dim_z + zs
    return (value_indices.astype(np.int32), stick_keys.astype(np.int32),
            centered, conj, "numpy", reason)


def convert_index_triplets(hermitian: bool, dim_x: int, dim_y: int, dim_z: int,
                           triplets: np.ndarray, native: bool = True):
    """Convert (n, 3) index triplets into per-value flat indices and the
    ordered unique stick-key list.

    Returns ``(value_indices, stick_keys, centered, conj)`` where
    ``value_indices[i] = stick_id(i) * dim_z + z_storage(i)``,
    ``stick_keys`` is the ascending list of unique ``x*dim_y + y`` keys,
    and ``conj`` is the hermitian folding mask (or None). ``native``
    takes the native planner where it can (see the module's docstring);
    both paths return the same tables and raise the same errors."""
    return _convert(hermitian, dim_x, dim_y, dim_z, triplets, native)[:4]


def check_stick_duplicates(stick_keys_per_shard: Sequence[np.ndarray]) -> None:
    """Raise if any z-stick appears on more than one shard
    (reference: indices.hpp:105-117)."""
    all_keys = np.concatenate([np.asarray(k) for k in stick_keys_per_shard]) \
        if stick_keys_per_shard else np.empty(0, np.int32)
    if all_keys.size != np.unique(all_keys).size:
        raise DuplicateIndicesError(
            "z-stick (x,y) index owned by more than one shard")


@dataclasses.dataclass(frozen=True)
class IndexPlan:
    """Static index tables for one shard's sparse frequency set — the
    local analogue of the reference ``Parameters`` object (reference:
    src/parameters/parameters.hpp:48-156)."""

    transform_type: TransformType
    dim_x: int
    dim_y: int
    dim_z: int
    centered: bool
    #: per-value flat index ``stick_id * dim_z + z`` (indices.hpp:168-176)
    value_indices: np.ndarray
    #: ascending unique ``x*dim_y + y`` stick keys (indices.hpp:179-185)
    stick_keys: np.ndarray
    #: per-value conjugate mask from hermitian x < 0 folding, or None
    value_conj: Optional[np.ndarray] = None
    #: which planner built the tables: ``"native"``, ``"numpy"``, or
    #: ``"given"`` (tables handed in, :mod:`~spfft_tpu_torch.convert`)
    planner: str = "given"
    #: why the numpy planner ran, or None
    planner_reason: Optional[str] = None

    @property
    def num_values(self) -> int:
        return int(self.value_indices.shape[0])

    @property
    def num_sticks(self) -> int:
        return int(self.stick_keys.shape[0])

    @property
    def hermitian(self) -> bool:
        return self.transform_type == TransformType.R2C

    @property
    def dim_x_freq(self) -> int:
        """Frequency-domain x extent: ``dim_x//2 + 1`` for R2C
        (reference: parameters.cpp:49), else ``dim_x``."""
        return self.dim_x // 2 + 1 if self.hermitian else self.dim_x

    @property
    def stick_x(self) -> np.ndarray:
        """Storage x index of each stick."""
        return self.stick_keys // self.dim_y

    @property
    def stick_y(self) -> np.ndarray:
        """Storage y index of each stick."""
        return self.stick_keys % self.dim_y

    @property
    def scatter_cols(self) -> np.ndarray:
        """Column of each stick in the *x-innermost* frequency plane
        ``(dim_y, dim_x_freq)`` flattened: ``y * dim_x_freq + x`` — the
        distributed plan's plane layout, whose xy stage ends in the user
        layout ``(z, y, x)`` with no transpose."""
        return (self.stick_y * self.dim_x_freq
                + self.stick_x).astype(np.int32)

    @property
    def scatter_cols_t(self) -> np.ndarray:
        """Column of each stick in the *y-innermost* frequency plane
        ``(dim_x_freq, dim_y)`` flattened: ``x * dim_y + y`` — exactly
        the stick key. The plane grid stays transposed (planes, x, y)
        through the y-stage, so both xy DFT axes contract on the minor
        dimension."""
        return self.stick_keys.astype(np.int32)

    @property
    def col_inv_t(self) -> np.ndarray:
        """Inverse of :attr:`scatter_cols_t` (see :func:`inverse_col_map`)."""
        return inverse_col_map(self.scatter_cols_t,
                               self.dim_x_freq * self.dim_y,
                               self.num_sticks)

    @property
    def slot_src(self) -> np.ndarray:
        """Inverse value map for the gather-based decompress (see
        :func:`inverse_slot_map`)."""
        return inverse_slot_map(self.value_indices,
                                self.num_sticks * self.dim_z,
                                self.num_values)

    @property
    def zero_stick_id(self) -> Optional[int]:
        """Position of the (x=0, y=0) stick, or None if absent — the stick
        that receives hermitian completion for R2C (reference:
        parameters.cpp:133-139)."""
        hits = np.nonzero(self.stick_keys == 0)[0]
        return int(hits[0]) if hits.size else None


def inverse_slot_map(value_indices: np.ndarray, num_slots: int,
                     num_values: int, native: bool = True) -> np.ndarray:
    """Invert the value->slot map: ``src[slot] = value index feeding that
    slot``, sentinel ``num_values`` for empty slots. Turns the
    reference's decompress scatter (compression_host.hpp:76-93) into a
    gather. If several duplicate triplets name one slot, the last
    occurrence wins. ``native`` takes the native planner's scatter where
    the library loads (int32 either way)."""
    if native:
        from .native import planner
        out = planner.inverse_map(value_indices, num_slots, num_values)
        if out is not None:
            return out
    src = np.full(num_slots, num_values, np.int32)
    src[value_indices] = np.arange(num_values, dtype=np.int32)
    return src


def inverse_col_map(scatter_cols: np.ndarray, num_cols: int,
                    num_sticks: int, native: bool = True) -> np.ndarray:
    """Invert the stick->plane-column map: ``col_inv[c] = stick id at
    column c``, sentinel ``num_sticks`` for empty columns
    (transpose_host.hpp:132-154 as a gather); ``native`` as in
    :func:`inverse_slot_map`."""
    if native:
        from .native import planner
        out = planner.inverse_map(scatter_cols, num_cols, num_sticks)
        if out is not None:
            return out
    col_inv = np.full(num_cols, num_sticks, np.int32)
    col_inv[scatter_cols] = np.arange(num_sticks, dtype=np.int32)
    return col_inv


def occupied_x_window(xs: np.ndarray, dim_x_freq: int,
                      allow_wrap: bool) -> tuple:
    """Minimal window ``[x0, x0 + w)`` (cyclic when ``allow_wrap``)
    covering the occupied storage-x columns (reference:
    execution_host.cpp:139-145). Returns ``(x0, w)`` with
    ``0 <= x0 < dim_x_freq`` and ``1 <= w <= dim_x_freq``; column ``x``
    maps to sub-column ``(x - x0) % dim_x_freq``."""
    u = np.unique(np.asarray(xs, np.int64))
    if u.size == 0:
        return 0, 1
    if u.size == dim_x_freq:
        return 0, dim_x_freq
    if not allow_wrap:
        return int(u[0]), int(u[-1] - u[0] + 1)
    # Largest cyclic gap between consecutive occupied columns: the window
    # is its complement.
    gaps = np.diff(np.concatenate([u, [u[0] + dim_x_freq]]))
    g = int(np.argmax(gaps))
    x0 = int(u[(g + 1) % u.size])
    w = dim_x_freq - int(gaps[g]) + 1
    return x0, w


def window_sub_cols(cols: np.ndarray, dim_x_freq: int, x0: int,
                    w: int) -> np.ndarray:
    """Map full-plane columns ``y * dim_x_freq + x`` to occupied-window
    columns ``y * w + (x - x0) % dim_x_freq`` (see
    :func:`occupied_x_window`): the one mapping the distributed plan's
    grid layout and exchange tables share."""
    cols = np.asarray(cols, np.int64)
    return ((cols // dim_x_freq) * w
            + (cols % dim_x_freq - x0) % dim_x_freq).astype(np.int32)


#: Largest representable element count for any derived size product
#: (reference: grid_internal.cpp:122-134).
MAX_SIZE_PRODUCT = 2 ** 62


def check_size_overflow(dim_x: int, dim_y: int, dim_z: int) -> None:
    """Raise :class:`~spfft_tpu_torch.errors.OverflowError_` when a size
    product the plan derives cannot be represented."""
    if int(dim_x) > 2 ** 31 - 1 or int(dim_y) > 2 ** 31 - 1 \
            or int(dim_z) > 2 ** 31 - 1:
        raise OverflowError_(
            f"dimension exceeds 32-bit index range "
            f"({dim_x},{dim_y},{dim_z})")
    if 2 * int(dim_x) * int(dim_y) * int(dim_z) > MAX_SIZE_PRODUCT:
        raise OverflowError_(
            f"grid size product 2*{dim_x}*{dim_y}*{dim_z} overflows the "
            f"64-bit size range")
    if int(dim_x) * int(dim_y) > 2 ** 31 - 1:
        raise OverflowError_(
            f"plane size {dim_x}*{dim_y} exceeds the int32 range of the "
            f"stick-key/column gather tables")


def build_index_plan(transform_type: TransformType,
                     dim_x: int, dim_y: int, dim_z: int,
                     triplets: np.ndarray, native: bool = True) -> IndexPlan:
    """Build the index plan for one shard's triplet list (validation as
    reference grid_internal.cpp:122-145, transform_internal.cpp:52-83);
    ``native`` as in :func:`convert_index_triplets`, and the planner that
    ran recorded in the plan."""
    if dim_x < 1 or dim_y < 1 or dim_z < 1:
        raise InvalidParameterError(
            f"dimensions must be >= 1, got ({dim_x},{dim_y},{dim_z})")
    check_size_overflow(dim_x, dim_y, dim_z)
    transform_type = TransformType(transform_type)
    hermitian = transform_type == TransformType.R2C
    value_indices, stick_keys, centered, value_conj, planner, reason = \
        _convert(hermitian, dim_x, dim_y, dim_z, triplets, native)
    num_sticks = int(stick_keys.shape[0])
    if num_sticks * int(dim_z) > 2 ** 31 - 1 \
            or int(value_indices.shape[0]) > 2 ** 31 - 1:
        raise OverflowError_(
            f"stick-slot count {num_sticks}*{dim_z} (or value count "
            f"{value_indices.shape[0]}) exceeds the int32 range of the "
            f"compression gather tables")
    return IndexPlan(transform_type=transform_type, dim_x=dim_x, dim_y=dim_y,
                     dim_z=dim_z, centered=centered,
                     value_indices=value_indices, stick_keys=stick_keys,
                     value_conj=value_conj, planner=planner,
                     planner_reason=reason)
