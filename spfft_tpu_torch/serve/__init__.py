"""spfft_tpu_torch.serve — transform-as-a-service on top of the port's
plans (the port of ``spfft_tpu/serve``, its single-host part).

* :mod:`~spfft_tpu_torch.serve.registry` — ``PlanRegistry``, a
  byte-aware bounded LRU of ``TransformPlan``s keyed by a canonical
  ``PlanSignature`` (dims, sparse-index digest, transform type,
  precision, scaling, device count: the JAX package's, bit for bit),
  with explicit ``warmup`` and hit/miss/eviction counters.
* :mod:`~spfft_tpu_torch.serve.executor` — ``ServeExecutor``, a
  concurrent batching executor: ``submit(signature, values)`` returns a
  future; a dispatcher thread buckets same-signature requests and runs
  each bucket through the plan's batched route (one launch of each
  kernel per bucket), with priority lanes, EDF, adaptive batch-shape
  pinning, pinned host staging and a pipelined in-flight window.
* :mod:`~spfft_tpu_torch.serve.metrics` — ``ServeMetrics``: latency
  reservoirs, queue depth, batch histograms, health.
* :mod:`~spfft_tpu_torch.serve.store` — ``PlanArtifactStore``, plan
  artifacts on disk (and a remote blob tier) that let a fresh process
  boot warm (``builds == 0``); ``python -m
  spfft_tpu_torch.serve.store``.
* :mod:`~spfft_tpu_torch.serve.faults` — ``FaultPlan`` and the failure
  classification behind the executor's bucket isolation, retries,
  quarantine and supervised dispatch.

The pod (``PodFrontend``, ``HostLane``, ``LoopbackTransport``,
``load_score``, ``simulate_routing``) is a later slice of this package:
those names raise the typed not-in-slice error.
"""

from ..errors import (ClusterError, ClusterReconciliationError,
                      DeadlineExpiredError, DistributedPlanUnsupportedError,
                      ExecutorCrashedError, HostLaneError,
                      NoHealthyDeviceError, PlanArtifactError,
                      QueueFullError, RetryExhaustedError, ServeError)
from .executor import PLAN_MANIFEST_ENV, ServeExecutor
from .faults import (FaultPlan, InjectedFault, attributes_device,
                     is_transient)
from .metrics import PRIORITY_CLASSES, ServeMetrics, percentile
from .registry import (PlanRegistry, PlanSignature, index_digest,
                       signature_for)

#: the pod's names, which a later slice of this package adds
_POD_NAMES = ("PodFrontend", "HostLane", "LoopbackTransport", "load_score",
              "simulate_routing")


def __getattr__(name):
    # PEP 562 lazy re-export: `python -m spfft_tpu_torch.serve.store`
    # runs store.py as __main__ AFTER this package imports — an eager
    # `from .store import ...` here would execute the module twice.
    if name in ("PlanArtifactStore", "PLAN_STORE_ENV"):
        from . import store
        return getattr(store, name)
    if name in _POD_NAMES:
        from ..plan import _not_in_slice
        raise _not_in_slice(f"spfft_tpu_torch.serve.{name} (the pod "
                            f"frontend)", "pod")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PlanRegistry", "PlanSignature", "index_digest", "signature_for",
    "ServeExecutor", "ServeMetrics", "percentile", "PRIORITY_CLASSES",
    "PlanArtifactStore", "PLAN_STORE_ENV", "PLAN_MANIFEST_ENV",
    "FaultPlan", "InjectedFault", "is_transient", "attributes_device",
    "ServeError", "QueueFullError", "DeadlineExpiredError",
    "RetryExhaustedError", "NoHealthyDeviceError",
    "ExecutorCrashedError", "DistributedPlanUnsupportedError",
    "PlanArtifactError",
    "PodFrontend", "HostLane", "LoopbackTransport", "load_score",
    "simulate_routing",
    "ClusterError", "HostLaneError", "ClusterReconciliationError",
]
