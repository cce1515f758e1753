"""Distributed plans over S shards (counterpart of
``spfft_tpu.parallel``): the shard mesh, the exchanges, their chunked
schedules and the distributed transform plan."""

from .dist import (DistributedIndexPlan, DistributedTransformPlan,
                   build_distributed_plan, make_distributed_plan)
from .mesh import Mesh, make_mesh
from .overlap import OverlapSchedule, build_overlap_schedule, chunk_bounds

__all__ = ["DistributedIndexPlan", "DistributedTransformPlan", "Mesh",
           "OverlapSchedule", "build_distributed_plan",
           "build_overlap_schedule", "chunk_bounds", "make_distributed_plan",
           "make_mesh"]
