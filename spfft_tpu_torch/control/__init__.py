"""spfft_tpu_torch.control — the telemetry-driven control plane (the port
of ``spfft_tpu/control``).

* :mod:`~spfft_tpu_torch.control.config` — :class:`ServeConfig`, the one
  typed home of every serving and execution knob: hot-swappable under a
  lock, bounds-clamped, every change recorded (history,
  ``spfft_control_*`` series, a ``control.knob`` journal event, a
  ``control.retune`` trace instant). ``SPFFT_TPU_SERVE_CONFIG`` loads a
  recommended-config artifact at boot; :func:`global_config` is the
  process-global instance.
* :mod:`~spfft_tpu_torch.control.controller` — :class:`Controller` /
  :class:`ControlLoop`, the deterministic rule-based feedback loop
  (hysteresis, step-counted cooldown, idle decay) retuning batch window,
  pin policy, bucket cap, pipeline depth, queue bound, overlap chunks,
  the wire rung, the SPMD window and cap and the lease TTL from live
  ``ServeMetrics.signals()`` (and ``SPMDCoalescer.signals()``).
* :mod:`~spfft_tpu_torch.control.slo` — :class:`SLOSpec` /
  :class:`SLOWatchdog`: declared objectives evaluated against metrics
  snapshots; burn rates exported as ``spfft_slo_*`` gauges, violations
  degrade ``health()``.
* ``python -m spfft_tpu_torch.control`` — ``tune`` (the offline
  auto-tuner over ``serve.bench`` and
  ``scripts/torch_bench_overlap_ab.py``, writes the boot artifact),
  ``show`` (knobs, bounds, signals), ``check`` (validate an artifact).
"""

from .config import (CONFIG_ENV, KNOB_SPECS, KnobSpec, ServeConfig,
                     global_config, set_global_config)
from .controller import MANAGED_KNOBS, ControlLoop, Controller, Decision
from .slo import SLOSpec, SLOWatchdog

__all__ = [
    "ServeConfig", "KnobSpec", "KNOB_SPECS", "CONFIG_ENV",
    "global_config", "set_global_config",
    "Controller", "ControlLoop", "Decision", "MANAGED_KNOBS",
    "SLOSpec", "SLOWatchdog",
]
