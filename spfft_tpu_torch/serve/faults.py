"""Fault injection for the serving layer: a re-export of
:mod:`spfft_tpu_torch.faults` (the counterpart of
``spfft_tpu/serve/faults.py``, which re-exports the JAX package's
``faults``). The executor's four check sites (``stage``, ``dispatch``,
``materialise``, ``loop``), the registry's and the store's are declared
there with every other site, so one ``FaultPlan`` script drives the
plans, the store and the executor alike.
"""

from __future__ import annotations

from ..faults import (KINDS, PERSISTENT_DISK_ERRNOS, REQUEST_ERROR_TYPES,
                      SITES, TRANSIENT_MARKERS, FaultPlan,
                      InjectedDiskFull, InjectedFault, arm, armed,
                      attributes_device, check_site, disarm,
                      is_persistent_disk_error, is_transient)

__all__ = [
    "FaultPlan", "InjectedFault", "InjectedDiskFull",
    "SITES", "KINDS", "TRANSIENT_MARKERS", "REQUEST_ERROR_TYPES",
    "PERSISTENT_DISK_ERRNOS",
    "is_transient", "attributes_device", "is_persistent_disk_error",
    "arm", "armed", "disarm", "check_site",
]
