"""SLO watchdog: declared objectives evaluated against live metrics (the
port of ``spfft_tpu/control/slo.py``: the same parsing, burn rates,
windows, gauges and verdicts).

An operator declares service-level objectives — p99 request latency, an
error-rate budget, a quarantine ceiling — and the watchdog evaluates
them against :class:`~spfft_tpu_torch.serve.metrics.ServeMetrics`
snapshots: each objective's BURN RATE (observed / objective) is exported
as a ``spfft_slo_*`` gauge, and when any burn rate exceeds the declared
budget the executor's ``health()`` flips to ``degraded`` (through
``ServeMetrics.record_slo``: the raw lifecycle state is kept; SLO
pressure only ever degrades an otherwise-healthy report, it cannot mask
a failed executor).

Declaration formats:

* programmatic — ``SLOSpec(latency_p99_s=0.050, error_rate=0.01,
  max_quarantines=0)`` (any subset; None = objective not declared);
* CLI string — ``"p99_ms=50,error_rate=0.01,max_quarantines=0"``
  (``serve.bench --slo``);
* JSON file — ``{"latency_p99_s": 0.05, "error_rate": 0.01,
  "max_quarantines": 0}`` (``--slo @objectives.json``).

Burn-rate semantics: for a positive objective, ``observed /
objective``; for a ZERO objective (e.g. ``max_quarantines=0`` — "never
quarantine"), any observation at all burns infinitely. A violation is
``burn > budget`` (budget default 1.0 — at the objective is still
within it). Evaluation is pure arithmetic over one metrics snapshot:
deterministic given the snapshot, cheap enough to run every controller
step, and it reads host counters only (no device synchronisation).

Multi-window alerting: a single evaluation's violation degrades
``health()`` at once (cheap, reversible), but paging on it would wake an
operator for every blip. The watchdog therefore also keeps two rolling
burn windows per objective — ``fast_window`` and ``slow_window``
evaluations (counts, not seconds: determinism again) — and raises the
page condition only while BOTH window means exceed the budget: the fast
window proves the burn is current, the slow window that it is
sustained. Exported as ``spfft_slo_window_burn_rate{slo,window}``,
``spfft_slo_window_alert`` and the rising-edge counter
``spfft_slo_window_alerts_total``; the rising edge also journals a
``slo.alert`` event and asks the flight recorder for an automatic
incident capture.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
from typing import Dict, List, Optional

from ..errors import InvalidParameterError


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declared objectives; ``None`` leaves an objective undeclared."""

    latency_p99_s: Optional[float] = None
    error_rate: Optional[float] = None
    max_quarantines: Optional[float] = None

    def __post_init__(self):
        for name in ("latency_p99_s", "error_rate", "max_quarantines"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, (int, float))
                                  or v < 0 or math.isnan(float(v))):
                raise InvalidParameterError(
                    f"SLO objective {name} must be a number >= 0, "
                    f"got {v!r}")

    def declared(self) -> Dict[str, float]:
        return {name: float(v) for name, v in dataclasses.asdict(
            self).items() if v is not None}

    @classmethod
    def parse(cls, text: str) -> "SLOSpec":
        """``"p99_ms=50,error_rate=0.01,max_quarantines=0"`` or
        ``"@file.json"`` (a JSON object of objective fields)."""
        text = text.strip()
        if text.startswith("@"):
            try:
                with open(text[1:]) as f:
                    payload = json.load(f)
            except (OSError, ValueError) as exc:
                raise InvalidParameterError(
                    f"cannot read SLO file {text[1:]!r}: {exc}")
            if not isinstance(payload, dict):
                raise InvalidParameterError(
                    f"SLO file {text[1:]!r} must hold a JSON object")
            try:
                return cls(**payload)
            except TypeError as exc:
                raise InvalidParameterError(f"bad SLO file: {exc}")
        kwargs: Dict[str, float] = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise InvalidParameterError(
                    f"bad SLO entry {part!r} (want key=value)")
            key, _, value = part.partition("=")
            key = key.strip()
            try:
                v = float(value)
            except ValueError:
                raise InvalidParameterError(
                    f"bad SLO value in {part!r}")
            if key in ("p99_ms", "latency_p99_ms"):
                kwargs["latency_p99_s"] = v / 1e3
            elif key in ("p99_s", "latency_p99_s"):
                kwargs["latency_p99_s"] = v
            elif key == "error_rate":
                kwargs["error_rate"] = v
            elif key == "max_quarantines":
                kwargs["max_quarantines"] = v
            else:
                raise InvalidParameterError(
                    f"unknown SLO objective {key!r} (want p99_ms / "
                    f"p99_s / error_rate / max_quarantines)")
        return cls(**kwargs)


def _burn(observed: float, objective: float) -> float:
    if objective > 0:
        return observed / objective
    return math.inf if observed > 0 else 0.0


class SLOWatchdog:
    """Evaluates an :class:`SLOSpec` against ``metrics`` snapshots.

    :meth:`evaluate` returns ``{"violations": [...], "burn": {...},
    "observed": {...}, "objectives": {...}}`` and pushes the result
    into the Prometheus registry and the metrics sink's health state.
    """

    def __init__(self, metrics, spec: SLOSpec, budget: float = 1.0,
                 fast_window: int = 6, slow_window: int = 30):
        if budget <= 0:
            raise InvalidParameterError("SLO budget must be > 0")
        if fast_window < 1 or slow_window < fast_window:
            raise InvalidParameterError(
                "want 1 <= fast_window <= slow_window, got "
                f"{fast_window}/{slow_window}")
        self.metrics = metrics
        self.spec = spec
        self.budget = float(budget)
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.evaluations = 0
        #: per-objective rolling burn history (slow_window deep) and
        #: the set of objectives currently in the page condition (for
        #: rising-edge counting) — evaluate() is the only writer
        self._burn_hist: Dict[str, collections.deque] = {}
        self._alerting: set = set()

    def _window_burns(self, name: str) -> Dict[str, float]:
        hist = self._burn_hist[name]
        fast = list(hist)[-self.fast_window:]
        slow = list(hist)
        return {"fast": sum(fast) / len(fast),
                "slow": sum(slow) / len(slow)}

    def _observed(self, signals: Dict) -> Dict[str, float]:
        completed = signals.get("completed", 0)
        failed = signals.get("failed", 0)
        total = completed + failed
        return {
            "latency_p99_s": signals.get("latency_p99", 0.0),
            "error_rate": (failed / total) if total else 0.0,
            "max_quarantines": signals.get("quarantines", 0),
        }

    def evaluate(self, signals: Optional[Dict] = None) -> Dict:
        """One evaluation over ``signals`` (defaults to a fresh
        ``metrics.signals()`` snapshot)."""
        if signals is None:
            signals = self.metrics.signals()
        observed_all = self._observed(signals)
        objectives = self.spec.declared()
        burn: Dict[str, float] = {}
        observed: Dict[str, float] = {}
        violations = []
        for name, objective in objectives.items():
            obs_v = observed_all[name]
            b = _burn(obs_v, objective)
            burn[name] = b
            observed[name] = obs_v
            if b > self.budget:
                violations.append(name)
        self.evaluations += 1
        window_burn: Dict[str, Dict[str, float]] = {}
        window_alerts: List[str] = []
        for name in objectives:
            hist = self._burn_hist.setdefault(
                name, collections.deque(maxlen=self.slow_window))
            hist.append(burn[name])
            window_burn[name] = self._window_burns(name)
            # Page only on evidence a full fast window deep: both
            # windows burning above budget. Shorter history is at most
            # a health degradation (the single-eval violation above),
            # never a page.
            if (len(hist) >= self.fast_window
                    and window_burn[name]["fast"] > self.budget
                    and window_burn[name]["slow"] > self.budget):
                window_alerts.append(name)
        from .. import obs
        obs.GLOBAL_COUNTERS.inc("spfft_slo_evaluations_total", 1,
                                help="SLO watchdog evaluations.")
        for name, objective in objectives.items():
            labels = {"slo": name}
            obs.GLOBAL_COUNTERS.set(
                "spfft_slo_objective", objective,
                help="Declared SLO objective value.", **labels)
            obs.GLOBAL_COUNTERS.set(
                "spfft_slo_observed", observed[name],
                help="Observed value at last SLO evaluation.", **labels)
            obs.GLOBAL_COUNTERS.set(
                "spfft_slo_burn_rate",
                burn[name] if math.isfinite(burn[name]) else -1.0,
                help="observed/objective at last evaluation (-1 = "
                     "infinite: a zero objective was burned).",
                **labels)
            obs.GLOBAL_COUNTERS.set(
                "spfft_slo_violation",
                1 if name in violations else 0,
                help="1 while this SLO's burn rate exceeds its budget.",
                **labels)
            for window in ("fast", "slow"):
                wb = window_burn[name][window]
                obs.GLOBAL_COUNTERS.set(
                    "spfft_slo_window_burn_rate",
                    wb if math.isfinite(wb) else -1.0,
                    help="Mean burn rate over each alerting window "
                         "(labels: slo, window=fast|slow; -1 = "
                         "infinite).",
                    slo=name, window=window)
            obs.GLOBAL_COUNTERS.set(
                "spfft_slo_window_alert",
                1 if name in window_alerts else 0,
                help="1 while BOTH burn windows of this SLO exceed "
                     "the budget (multi-window page condition).",
                **labels)
        for name in window_alerts:
            if name not in self._alerting:
                obs.GLOBAL_COUNTERS.inc(
                    "spfft_slo_window_alerts_total", 1,
                    help="Multi-window page conditions entered.",
                    slo=name)
                obs.record_event("slo.alert", slo=name)
                # the rising edge is a flight-recorder auto trigger:
                # snapshot the black box the moment the page condition
                # is entered, not when an operator notices
                obs.maybe_auto_capture("slo_alert", name)
        self._alerting = set(window_alerts)
        if violations:
            obs.GLOBAL_COUNTERS.inc(
                "spfft_slo_violations_total", len(violations),
                help="SLO violations observed across evaluations.")
        if obs.active():
            obs.GLOBAL_TRACER.instant(
                "slo.evaluate", cat="control", track="control",
                args={"violations": ",".join(violations) or "none",
                      "budget": self.budget})
        if self.metrics is not None:
            self.metrics.record_slo(violations)
        return {"violations": violations, "burn": burn,
                "observed": observed, "objectives": objectives,
                "budget": self.budget, "window_burn": window_burn,
                "window_alerts": window_alerts}
