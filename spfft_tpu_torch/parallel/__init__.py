"""Distributed plans over S shards (counterpart of
``spfft_tpu.parallel``): the shard mesh (on one device, or over the ranks
of a ``torch.distributed`` process group), the exchanges, their chunked
schedules, the distributed transform plan and the plan-time multi-process
protocol."""

from .dist import (DistributedIndexPlan, DistributedTransformPlan,
                   build_distributed_plan, make_distributed_plan)
from .mesh import Mesh, make_mesh
from .multihost import (build_distributed_plan_multihost, initialize,
                        plan_fingerprint, validate_consistent)
from .overlap import OverlapSchedule, build_overlap_schedule, chunk_bounds

#: the JAX package's exported name of :func:`.multihost.initialize`
initialize_multihost = initialize

__all__ = ["DistributedIndexPlan", "DistributedTransformPlan", "Mesh",
           "OverlapSchedule", "build_distributed_plan",
           "build_distributed_plan_multihost", "build_overlap_schedule",
           "chunk_bounds", "initialize", "initialize_multihost",
           "make_distributed_plan", "make_mesh", "plan_fingerprint",
           "validate_consistent"]
