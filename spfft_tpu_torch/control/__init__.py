"""spfft_tpu_torch.control — the typed home of the package's knobs.

Only :mod:`~spfft_tpu_torch.control.config` is ported so far: its
:class:`ServeConfig` (hot-swappable under a lock, bounds-clamped, every
change recorded as ``spfft_control_*`` series, a ``control.knob``
journal event and a ``control.retune`` trace instant), the
``SPFFT_TPU_SERVE_CONFIG`` boot artifact and the process-global
:func:`global_config`. The JAX package's feedback controller
(``controller.py``) and SLO watchdog (``slo.py``) come with the serving
slice, and this package then exports their names too.
"""

from .config import (CONFIG_ENV, KNOB_SPECS, KnobSpec, ServeConfig,
                     global_config, set_global_config)

__all__ = [
    "ServeConfig", "KnobSpec", "KNOB_SPECS", "CONFIG_ENV",
    "global_config", "set_global_config",
]
