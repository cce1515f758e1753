"""Public enums of spfft_tpu_torch.

The same members and values as ``spfft_tpu.types``, which mirror the
reference's ``SpfftExchangeType`` / ``SpfftProcessingUnitType`` /
``SpfftIndexFormatType`` / ``SpfftTransformType`` / ``SpfftScalingType``
(reference: include/spfft/types.h:33-106). Kept as a copy so that this
package imports without JAX; equal values let a caller translate one
enum into the other with ``Enum(other.value)``.
"""

from __future__ import annotations

import enum


class ExchangeType(enum.Enum):
    """Distributed exchange algorithm selector (reference: types.h:33-62).
    The distributed plan (``parallel.dist``) runs ``DEFAULT`` and
    ``BUFFERED``, the block exchange; the others raise a typed
    not-in-slice error, and their values translate between the two
    packages."""

    DEFAULT = "default"
    BUFFERED = "buffered"
    BUFFERED_FLOAT = "buffered_float"
    COMPACT_BUFFERED = "compact_buffered"
    COMPACT_BUFFERED_FLOAT = "compact_buffered_float"
    UNBUFFERED = "unbuffered"

    @property
    def float_wire(self) -> bool:
        """True if the on-wire precision is reduced (reference: types.h:43-57)."""
        return self in (ExchangeType.BUFFERED_FLOAT,
                        ExchangeType.COMPACT_BUFFERED_FLOAT)

    @property
    def compact(self) -> bool:
        """True if the exact-count (ragged) schedule is selected."""
        return self in (ExchangeType.COMPACT_BUFFERED,
                        ExchangeType.COMPACT_BUFFERED_FLOAT)


class ProcessingUnit(enum.IntFlag):
    """Where transform I/O lives (reference: types.h:67-76)."""

    HOST = 1    # SPFFT_PU_HOST
    DEVICE = 2  # SPFFT_PU_GPU — CUDA device memory


class IndexFormat(enum.Enum):
    """Sparse frequency-index format (reference: types.h:78-83)."""

    TRIPLETS = "triplets"  # SPFFT_INDEX_TRIPLETS: interleaved x,y,z


class TransformType(enum.Enum):
    """Transform kind (reference: types.h:85-95)."""

    C2C = "c2c"
    R2C = "r2c"


class Scaling(enum.Enum):
    """Forward-transform scaling (reference: types.h:97-106)."""

    NONE = "none"   # SPFFT_NO_SCALING
    FULL = "full"   # SPFFT_FULL_SCALING: multiply forward output by 1/(Nx*Ny*Nz)
