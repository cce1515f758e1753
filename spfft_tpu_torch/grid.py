"""The reference-shaped user API: ``Grid`` and ``Transform`` (counterpart
of ``spfft_tpu.grid``, its local part).

Mirrors the reference public surface (reference:
include/spfft/grid.hpp:49-203, include/spfft/transform.hpp:56-227) so
code written against SpFFT maps mechanically:

* The reference ``Grid`` pre-allocates scratch arrays sized to
  caller-declared maxima and every transform carves views out of them
  (reference: grid_internal.cpp:75-98, 207-227). Here PyTorch's caching
  allocator owns the scratch, so ``Grid`` keeps the limit-validation
  role (transforms must fit the declared maxima — reference
  transform_internal.cpp:52-83) and the device its transforms run on.
* ``Transform::space_domain_data`` exposes the space-domain buffer
  (reference: transform.hpp:184). Here the transform holds the latest
  space-domain tensor: ``backward`` returns and stores it, ``forward``
  uses the stored one unless one is passed.
* The float twins (``GridFloat``/``TransformFloat``, reference
  grid_float.hpp) collapse into the ``precision`` argument.

Distributed grids (``mesh=``, ``triplets_per_shard=``) are not in this
slice of the port and raise a typed error.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .errors import InvalidParameterError
from .indexing import build_index_plan
from .plan import TransformPlan, _not_in_slice, resolve_device
from .types import ExchangeType, IndexFormat, ProcessingUnit, Scaling, \
    TransformType


class Grid:
    """Transform factory with caller-declared size limits:
    ``Grid(max_dim_x, max_dim_y, max_dim_z, max_num_local_z_sticks)``
    (reference: grid.hpp:64-80). Its transforms run on ``device``: CUDA
    by default, ``"cpu"`` for the plain PyTorch versions."""

    def __init__(self, max_dim_x: int, max_dim_y: int, max_dim_z: int,
                 max_num_local_z_sticks: int,
                 processing_unit: ProcessingUnit = ProcessingUnit.DEVICE,
                 num_threads: int = -1,
                 mesh=None,
                 max_local_z_length: Optional[int] = None,
                 exchange: ExchangeType = ExchangeType.DEFAULT,
                 precision: str = "single",
                 device=None):
        for name, v in (("max_dim_x", max_dim_x), ("max_dim_y", max_dim_y),
                        ("max_dim_z", max_dim_z)):
            if v < 1:
                raise InvalidParameterError(f"{name} must be >= 1, got {v}")
        if max_num_local_z_sticks < 0:
            raise InvalidParameterError("max_num_local_z_sticks must be >= 0")
        if mesh is not None:
            raise _not_in_slice("a distributed Grid (mesh=)", "distributed")
        self._max_dim_x = max_dim_x
        self._max_dim_y = max_dim_y
        self._max_dim_z = max_dim_z
        self._max_num_local_z_sticks = max_num_local_z_sticks
        self._max_local_z_length = (max_local_z_length
                                    if max_local_z_length is not None
                                    else max_dim_z)
        self._processing_unit = ProcessingUnit(processing_unit)
        self._num_threads = num_threads
        self._exchange = ExchangeType(exchange)
        self._precision = precision
        self._device = resolve_device(device)

    def copy(self) -> "Grid":
        """Deep-copy constructor parity (reference grid.hpp:82-90). Plans
        own no scratch buffers, so a Grid with the same limits is the
        deep copy."""
        return Grid(self._max_dim_x, self._max_dim_y, self._max_dim_z,
                    self._max_num_local_z_sticks, self._processing_unit,
                    self._num_threads, None, self._max_local_z_length,
                    self._exchange, self._precision, self._device)

    __copy__ = copy
    __deepcopy__ = lambda self, memo: self.copy()  # noqa: E731

    # -- getters (reference grid.hpp:144-203) --------------------------------
    @property
    def max_dim_x(self) -> int:
        return self._max_dim_x

    @property
    def max_dim_y(self) -> int:
        return self._max_dim_y

    @property
    def max_dim_z(self) -> int:
        return self._max_dim_z

    @property
    def max_num_local_z_columns(self) -> int:
        return self._max_num_local_z_sticks

    @property
    def max_local_z_length(self) -> int:
        return self._max_local_z_length

    @property
    def processing_unit(self) -> ProcessingUnit:
        return self._processing_unit

    @property
    def num_threads(self) -> int:
        """Kept for API parity (reference: grid.hpp:188, the OpenMP
        thread count)."""
        return self._num_threads

    @property
    def mesh(self):
        """The device mesh of a distributed grid: always None here."""
        return None

    @property
    def distributed(self) -> bool:
        return False

    @property
    def device(self) -> torch.device:
        """The device this grid's transforms run on."""
        return self._device

    # -- factory (reference grid.hpp:113-141) --------------------------------
    def create_transform(self, processing_unit: ProcessingUnit,
                         transform_type: TransformType,
                         dim_x: int, dim_y: int, dim_z: int,
                         local_z_length: Optional[int] = None,
                         num_local_elements: Optional[int] = None,
                         index_format: IndexFormat = IndexFormat.TRIPLETS,
                         indices=None,
                         planes_per_shard: Optional[Sequence[int]] = None,
                         triplets_per_shard: Optional[Sequence] = None,
                         ) -> "Transform":
        """Create a transform within this grid's limits from ``indices``,
        an (n, 3) triplet array (or flat interleaved x,y,z like the
        reference C API). Validation mirrors reference
        transform_internal.cpp:52-83."""
        IndexFormat(index_format)  # only TRIPLETS exists (types.h:78-83)
        transform_type = TransformType(transform_type)
        ProcessingUnit(processing_unit)
        if dim_x > self._max_dim_x or dim_y > self._max_dim_y \
                or dim_z > self._max_dim_z:
            raise InvalidParameterError(
                f"transform dims ({dim_x},{dim_y},{dim_z}) exceed grid maxima "
                f"({self._max_dim_x},{self._max_dim_y},{self._max_dim_z})")
        if triplets_per_shard is not None or planes_per_shard is not None:
            raise _not_in_slice("a distributed transform "
                                "(triplets_per_shard=, planes_per_shard=)",
                                "distributed")
        if indices is None:
            raise InvalidParameterError("indices are required")
        triplets = np.asarray(indices)
        if triplets.ndim == 1:
            # reference C API passes flat interleaved x1,y1,z1,x2,...
            if triplets.size % 3 != 0:
                raise InvalidParameterError(
                    f"flat index array length ({triplets.size}) is not a "
                    "multiple of 3 (expected interleaved x,y,z triplets)")
            triplets = triplets.reshape(-1, 3)
        if num_local_elements is not None \
                and triplets.shape[0] != num_local_elements:
            raise InvalidParameterError(
                f"num_local_elements ({num_local_elements}) != number of "
                f"triplets ({triplets.shape[0]})")
        if local_z_length is not None and local_z_length != dim_z:
            raise InvalidParameterError(
                "local transform requires local_z_length == dim_z")
        index_plan = build_index_plan(transform_type, dim_x, dim_y, dim_z,
                                      triplets)
        if index_plan.num_sticks > self._max_num_local_z_sticks:
            raise InvalidParameterError(
                f"{index_plan.num_sticks} z sticks exceed grid limit "
                f"{self._max_num_local_z_sticks}")
        return Transform(TransformPlan(index_plan, precision=self._precision,
                                       device=self._device))


class Transform:
    """Handle to one sparse FFT plan, with the reference's execution
    surface (reference: transform.hpp:85-211)."""

    def __init__(self, plan: TransformPlan):
        self._plan = plan
        self._space = None

    # -- getters (reference transform.hpp:91-171) ---------------------------
    @property
    def plan(self) -> TransformPlan:
        return self._plan

    @property
    def type(self) -> TransformType:
        return self._plan.transform_type

    @property
    def dim_x(self) -> int:
        return self._plan.dim_x

    @property
    def dim_y(self) -> int:
        return self._plan.dim_y

    @property
    def dim_z(self) -> int:
        return self._plan.dim_z

    @property
    def distributed(self) -> bool:
        return False

    @property
    def processing_unit(self) -> ProcessingUnit:
        """DEVICE semantics always: results stay on the plan's device;
        host input is accepted everywhere."""
        return ProcessingUnit.DEVICE

    @property
    def precision(self) -> str:
        return self._plan.precision

    @property
    def exchange_type(self) -> ExchangeType:
        """Local transforms have no exchange: DEFAULT."""
        return ExchangeType.DEFAULT

    @property
    def num_shards(self) -> int:
        return 1

    @property
    def device_id(self) -> int:
        """The CUDA ordinal the plan runs on (reference transform.hpp:157
        returns the GPU device id); -1 for a plan on the CPU."""
        d = self._plan.device
        return -1 if d.type == "cpu" else int(d.index)

    @property
    def num_threads(self) -> int:
        """The device count the plan spans (reference transform.hpp:164
        returns the OpenMP thread count)."""
        return self.num_shards

    @property
    def global_size(self) -> int:
        return self._plan.global_size

    @property
    def num_global_elements(self) -> int:
        return self._plan.num_global_elements

    def local_z_length(self, shard: int = 0) -> int:
        return self._plan.local_z_length

    def local_z_offset(self, shard: int = 0) -> int:
        return 0

    def local_slice_size(self, shard: int = 0) -> int:
        return self.dim_x * self.dim_y * self.local_z_length(shard)

    def num_local_elements(self, shard: int = 0) -> int:
        return self._plan.num_local_elements

    def clone(self) -> "Transform":
        """A new independent handle over the same plan (reference
        transform.hpp:85)."""
        return Transform(self._plan)

    # -- space-domain access (reference transform.hpp:184) -------------------
    def space_domain_data(self, location: Optional[ProcessingUnit] = None):
        """The current space-domain data: set by ``backward``, consumed
        by ``forward``; None until one of them ran or the setter was
        used. ``ProcessingUnit.HOST`` returns a READ-ONLY numpy snapshot
        (ported reference code that writes into it fails loudly instead
        of changing nothing); ``DEVICE`` (or None) returns the data where
        it lives. To feed modified data into ``forward``, pass it
        explicitly or call :meth:`set_space_domain_data`."""
        if self._space is None or location is None:
            return self._space
        if ProcessingUnit(location) == ProcessingUnit.HOST:
            if isinstance(self._space, torch.Tensor):
                snap = self._space.detach().cpu().numpy().copy()
            else:
                snap = np.array(self._space)
            snap.flags.writeable = False
            return snap
        return self._space

    def set_space_domain_data(self, space) -> None:
        self._space = space

    # -- execution (reference transform.hpp:198-211) -------------------------
    def backward(self, values):
        """Frequency -> space; stores and returns the space-domain data."""
        self._space = self._plan.backward(values)
        return self._space

    def forward(self, space=None, scaling: Scaling = Scaling.NONE):
        """Space -> frequency, from ``space`` or the stored space-domain
        data."""
        src = space if space is not None else self._space
        if src is None:
            raise InvalidParameterError(
                "no space-domain data: run backward() or "
                "set_space_domain_data() first")
        result = self._plan.forward(src, scaling)
        if space is not None:  # store only after validation succeeded
            self._space = space
        return result
