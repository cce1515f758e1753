"""Distributed plans over S shards (counterpart of
``spfft_tpu.parallel``): the shard mesh, the block exchange and the
distributed transform plan."""

from .dist import (DistributedIndexPlan, DistributedTransformPlan,
                   build_distributed_plan, make_distributed_plan)
from .mesh import Mesh, make_mesh

__all__ = ["DistributedIndexPlan", "DistributedTransformPlan", "Mesh",
           "build_distributed_plan", "make_distributed_plan", "make_mesh"]
