"""Typed error taxonomy of spfft_tpu_torch.

The same classes and the same :class:`ErrorCode` values as the JAX
package's ``spfft_tpu.errors``, which mirror the reference's exception
hierarchy and C error-code enum (reference: include/spfft/exceptions.hpp,
include/spfft/errors.h). A copy rather than an import: importing any
module of ``spfft_tpu`` runs its package ``__init__``, which imports JAX,
and this package never imports JAX.

On this package, :class:`DeviceError` reports CUDA failures: no CUDA
device where one is needed, a kernel that does not build, or a launch
that the CUDA runtime refuses.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Stable error codes, mirroring ``SpfftError`` (reference:
    errors.h:33-126)."""

    SUCCESS = 0
    UNKNOWN = 1
    INVALID_HANDLE = 2
    OVERFLOW = 3
    ALLOCATION = 4
    INVALID_PARAMETER = 5
    DUPLICATE_INDICES = 6
    INVALID_INDICES = 7
    DISTRIBUTED_SUPPORT = 8   # reference: SPFFT_MPI_SUPPORT_ERROR
    DISTRIBUTED = 9           # reference: SPFFT_MPI_ERROR
    PARAMETER_MISMATCH = 10   # reference: SPFFT_MPI_PARAMETER_MISMATCH_ERROR
    HOST_EXECUTION = 11
    FFT = 12                  # reference: SPFFT_FFTW_ERROR
    DEVICE = 13               # reference: SPFFT_GPU_ERROR
    DEVICE_PRECEDING = 14
    DEVICE_SUPPORT = 15
    DEVICE_ALLOCATION = 16
    DEVICE_LAUNCH = 17
    DEVICE_NO_DEVICE = 18
    DEVICE_INVALID_VALUE = 19
    DEVICE_INVALID_DEVICE_PTR = 20
    DEVICE_COPY = 21
    DEVICE_FFT = 22


class GenericError(Exception):
    """Base class for all errors of this package (reference:
    exceptions.hpp:40-47)."""

    code = ErrorCode.UNKNOWN

    def error_code(self) -> ErrorCode:
        return self.code


class OverflowError_(GenericError):
    """Integer overflow in size computation (reference: exceptions.hpp:50-59)."""

    code = ErrorCode.OVERFLOW


class AllocationError(GenericError):
    """Failed buffer allocation (reference: exceptions.hpp:62-71)."""

    code = ErrorCode.ALLOCATION


class InvalidParameterError(GenericError):
    """Invalid parameter passed to a plan or transform, or a mode that
    this package does not cover yet (reference: exceptions.hpp:74-83)."""

    code = ErrorCode.INVALID_PARAMETER


class DuplicateIndicesError(GenericError):
    """Duplicate z-stick indices — a z-column owned by two shards
    (reference: exceptions.hpp:86-95, indices.hpp:105-117)."""

    code = ErrorCode.DUPLICATE_INDICES


class InvalidIndicesError(GenericError):
    """Frequency-domain index triplet out of bounds
    (reference: exceptions.hpp:98-107, indices.hpp:137-149)."""

    code = ErrorCode.INVALID_INDICES


class DistributedSupportError(GenericError):
    """Distributed operation requested without a process group
    (reference: exceptions.hpp:110-121, MPISupportError)."""

    code = ErrorCode.DISTRIBUTED_SUPPORT


class DistributedError(GenericError):
    """Failure in a collective operation (reference: exceptions.hpp:124-131)."""

    code = ErrorCode.DISTRIBUTED


class ParameterMismatchError(GenericError):
    """Plan parameters disagree across ranks (reference:
    exceptions.hpp:134-145)."""

    code = ErrorCode.PARAMETER_MISMATCH


class HostExecutionError(GenericError):
    """Failed execution on host (reference: exceptions.hpp:148-157)."""

    code = ErrorCode.HOST_EXECUTION


class TableBuildError(HostExecutionError):
    """A plan's table build raised; ``cause`` carries the original
    exception (also chained as ``__cause__``)."""

    def __init__(self, message: str, cause: BaseException = None):
        super().__init__(message)
        self.cause = cause
        if cause is not None:
            self.__cause__ = cause


class ServeError(HostExecutionError):
    """Base class of serving-layer failures."""


class QueueFullError(ServeError):
    """A serving executor's bounded request queue is full."""


class DeadlineExpiredError(ServeError):
    """A request's deadline elapsed before it was dispatched."""


class RetryExhaustedError(ServeError):
    """A request failed on its one bounded retry; ``cause`` carries the
    final attempt's exception."""

    def __init__(self, message: str, cause: BaseException = None):
        super().__init__(message)
        self.cause = cause
        if cause is not None:
            self.__cause__ = cause


class NoHealthyDeviceError(ServeError):
    """Every device of a serving pool is quarantined."""

    code = ErrorCode.DEVICE_NO_DEVICE


class DistributedPlanUnsupportedError(ServeError):
    """A distributed plan was submitted to a single-host executor."""

    code = ErrorCode.DISTRIBUTED_SUPPORT


class ClusterError(ServeError):
    """Base class of pod-frontend failures."""

    code = ErrorCode.DISTRIBUTED


class HostLaneError(ClusterError):
    """A host lane's RPC failed or the lane is marked dead."""

    transient = True

    def __init__(self, message: str, host: str = None):
        super().__init__(message)
        self.host = host


class ClusterReconciliationError(ClusterError):
    """Hosts of a pod disagree on their plan set."""

    code = ErrorCode.PARAMETER_MISMATCH


class NetProtocolError(ClusterError):
    """A wire frame failed to parse."""

    transient = True


class StaleEpochError(ClusterError):
    """Work carried a membership epoch older than the receiver's."""

    transient = True

    def __init__(self, message: str, stale: int = None,
                 current: int = None):
        super().__init__(message)
        self.stale = stale
        self.current = current


class NetAuthError(ClusterError):
    """Wire-authentication failure."""

    transient = False


class ExecutorCrashedError(ServeError):
    """A serving dispatch loop crashed past its restart budget."""


class ExecuteTimeoutError(ServeError):
    """A device execution exceeded its watchdog."""

    transient = True
    device_attributed = True


class PlanArtifactError(ServeError):
    """A plan artifact could not be loaded."""


class BlobStoreError(ServeError):
    """A remote blob-tier operation failed."""


class FFTError(GenericError):
    """Failure inside the FFT backend (reference: exceptions.hpp:160-167)."""

    code = ErrorCode.FFT


class PrecisionContractError(FFTError):
    """A plan's predicted relative error exceeds the ``max_rel_error``
    the caller demanded."""


class InternalError(GenericError):
    """Internal consistency failure (reference: exceptions.hpp:170-177)."""

    code = ErrorCode.UNKNOWN


class DeviceError(GenericError):
    """CUDA device failure: no device where one is needed, a kernel
    that does not build, or a refused launch (reference:
    exceptions.hpp:183-190, GPUError branch)."""

    code = ErrorCode.DEVICE


class KernelBuildError(DeviceError):
    """A CUDA kernel that does not build or load (``nvcc`` missing,
    failing or running past its time limit, a library that does not load
    or lacks an entry).
    The code is at fault, not the card: ``device_attributed = False``,
    so the fused kernels' runtime demotion ladder re-raises it instead of
    demoting, and it is permanent."""

    transient = False
    device_attributed = False


class DeviceSupportError(DeviceError):
    """Device execution requested but no accelerator is available
    (reference: exceptions.hpp:193-204)."""

    code = ErrorCode.DEVICE_SUPPORT


class DeviceAllocationError(DeviceError):
    """Failed allocation on device (reference: exceptions.hpp:221-230)."""

    code = ErrorCode.DEVICE_ALLOCATION


class DeviceFFTError(DeviceError):
    """Failure in the device FFT path (reference: exceptions.hpp:295-304)."""

    code = ErrorCode.DEVICE_FFT
