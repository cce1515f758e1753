"""ServeConfig: the typed home of every serving and execution knob (the
port of ``spfft_tpu/control/config.py``: the same knobs, defaults,
bounds, types, counters and artifact format).

One :class:`ServeConfig` object

* declares every knob once, with its default, hard bounds and the
  telemetry signal that drives it (:data:`KNOB_SPECS`);
* is hot-swappable under a lock: a writer retunes a knob with
  :meth:`ServeConfig.set` while readers read the same object, and the
  new value applies from the reader's next access;
* bounds-clamps every write and records every accepted change as a
  decision: a bounded in-memory history, a
  ``spfft_control_decisions_total{knob,source}`` counter, a
  ``spfft_control_knob{knob}`` gauge, a ``control.knob`` journal event
  and, when tracing is on, a ``control.retune`` instant on the
  ``control`` track;
* round-trips a JSON artifact (:meth:`save` / :meth:`load`), the JAX
  package's format, so an artifact either package writes loads in the
  other; :meth:`boot` loads the one the ``SPFFT_TPU_SERVE_CONFIG``
  environment variable names.

The distributed plan reads its ``overlap_chunks``, ``wire_precision``
and ``wire_error_budget`` defaults from :func:`global_config` where the
caller passes none and the environment sets none, as the JAX package's
does.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..errors import InvalidParameterError

#: Boot artifact location: when set, :meth:`ServeConfig.boot` (the
#: executor's default config source) loads this JSON file — the
#: auto-tuner's output becomes the fleet's serving defaults without a
#: code change. A malformed artifact raises at boot (fail fast: a typo'd
#: config silently ignored is worse than a crashed boot).
CONFIG_ENV = "SPFFT_TPU_SERVE_CONFIG"

#: Artifact schema marker (bumped on incompatible format changes).
ARTIFACT_KEY = "spfft_tpu_serve_config"
ARTIFACT_VERSION = 1

#: Decisions kept in each config's in-memory history (ring).
HISTORY_LIMIT = 256


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One knob's declaration: default, hard clamp bounds, type and the
    telemetry signal a controller drives it from (documentation)."""

    name: str
    default: float
    lo: float
    hi: float
    kind: type                  # int or float
    signal: str                 # what drives it (docs + CLI `show`)
    doc: str

    def clamp(self, value) -> float:
        v = self.kind(value)
        if v < self.lo:
            v = self.kind(self.lo)
        elif v > self.hi:
            v = self.kind(self.hi)
        return v


#: Every knob the control plane owns, with the JAX package's names,
#: defaults, bounds and types (a test holds the two tables equal); the
#: serving knobs wait for the serving slice's modules, which read them.
KNOB_SPECS: Dict[str, KnobSpec] = {spec.name: spec for spec in (
    KnobSpec("batch_window", 0.001, 0.0, 0.1, float,
             "queue-wait p95 vs device-execute p50",
             "Same-signature batching window (seconds) a trickle bucket "
             "waits for company."),
    KnobSpec("max_batch", 8, 1, 128, int,
             "fused batch histogram + queue depth",
             "Bucket cap: most live rows one fused dispatch carries."),
    KnobSpec("max_queue", 256, 1, 65536, int,
             "rejected_queue_full counter",
             "Bounded request queue capacity (overflow rejects, "
             "QueueFullError)."),
    KnobSpec("pin_after", 3, 0, 64, int,
             "padded-rows ratio",
             "Consecutive same-size fused buckets before that exact "
             "shape is pinned (0 disables pinning)."),
    KnobSpec("max_pinned_shapes", 4, 1, 64, int,
             "pinned-shape churn",
             "Pinned exact batch shapes kept per signature (LRU)."),
    KnobSpec("pipeline_depth", 0, 0, 32, int,
             "stage-vs-dispatch overlap ratio",
             "In-flight bucket window; 0 = backend-aware auto (pool+1 "
             "on accelerators, pool on CPU)."),
    KnobSpec("quarantine_after", 3, 0, 64, int,
             "device-attributed failure streaks",
             "Consecutive device-attributed failures before a pool "
             "device is quarantined (0 disables)."),
    KnobSpec("quarantine_backoff", 0.25, 0.001, 60.0, float,
             "probation outcomes",
             "Initial quarantine probation backoff (seconds, doubles "
             "per failed canary)."),
    KnobSpec("overlap_chunks", 1, 1, 64, int,
             "per-chunk wire bytes + async-split evidence",
             "Distributed exchange pipeline chunks K (1 = monolithic, "
             "bit-identical path)."),
    KnobSpec("registry_max_bytes", 2 * 1024 ** 3, 1024 ** 2,
             64 * 1024 ** 3, int,
             "registry bytes_in_use / evictions",
             "Plan registry LRU byte budget over estimated plan "
             "residency."),
    KnobSpec("registry_max_plans", 32, 1, 4096, int,
             "registry evictions",
             "Plan registry LRU entry cap."),
    KnobSpec("plan_store_max_bytes", 16 * 1024 ** 3, 0,
             1024 ** 4, int,
             "spfft_store_{spills,evictions}_total",
             "Persistent plan-artifact store byte cap (oldest-first "
             "GC on spill; 0 = unbounded)."),
    KnobSpec("fused_target_r", 64, 8, 512, int,
             "measured chip profiles (offline retune)",
             "Fused-kernel super-tile row target R: decompress+z-DFT "
             "gather window sizing (ops/fused_kernel.py cost model)."),
    KnobSpec("fused_recompute_limit", 4.0, 1.0, 64.0, float,
             "spfft_plan_pallas_fallback_total{reason=recompute_blowup}",
             "Fused compress recompute-blowup gate: decline when "
             "windowed gather rows exceed this multiple of the stick "
             "count."),
    KnobSpec("execute_timeout_ms", 0, 0, 600_000, int,
             "spfft_execute_timeouts_total",
             "Per-bucket device-execute watchdog (ms): a "
             "materialisation exceeding it is abandoned and failed as "
             "a typed transient ExecuteTimeoutError feeding the retry "
             "+ quarantine ladder (0 = off)."),
    KnobSpec("net_connect_timeout_ms", 2000, 1, 600_000, int,
             "spfft_cluster_rpc_failures_total",
             "TCP connect timeout (ms) for a host lane's wire RPCs: "
             "an unreachable agent fails over this fast."),
    KnobSpec("net_rpc_timeout_ms", 30_000, 1, 600_000, int,
             "spfft_net_rpc_rtt_seconds",
             "Per-RPC socket read timeout (ms) on the pod wire; a "
             "submit adds the request's own deadline on top."),
    KnobSpec("spmd_batch_window", 0.002, 0.0, 0.1, float,
             "SPMD queue depth vs collective-launch p50",
             "Coalescing window (seconds) the pod SPMD lane holds a "
             "distributed request open for same-signature company "
             "before launching the collective round."),
    KnobSpec("spmd_max_batch", 8, 1, 128, int,
             "SPMD batch-size histogram",
             "Most distributed requests one coalesced SPMD collective "
             "round carries."),
    KnobSpec("lease_ttl_ms", 1500, 50, 600_000, int,
             "spfft_net_rpc_rtt_seconds inflation vs the TTL",
             "Membership lease lifetime (ms): an agent whose heartbeat "
             "has not renewed its lease within this window starts down "
             "the suspected->probed->evicted ladder. The controller "
             "widens it when observed wire RTT inflates toward it."),
    KnobSpec("heartbeat_interval_ms", 500, 10, 600_000, int,
             "spfft_membership_heartbeats_total",
             "How often an agent renews its membership lease with the "
             "view coordinator (ms); keep well under lease_ttl_ms."),
    KnobSpec("lane_probe_backoff", 0.25, 0.001, 60.0, float,
             "spfft_cluster_probes_total",
             "Base backoff (seconds) before the pod frontend's first "
             "health probe of a dead lane; doubles per failed probe "
             "with jitter, capped at 64x."),
    KnobSpec("blob_store_max_bytes", 0, 0, 1024 ** 4, int,
             "spfft_blob_gc_total",
             "Byte cap for the remote blob tier's req/ request-journal "
             "namespace: the gc sweep evicts oldest-mtime keys past it "
             "(0 = unbounded, no sweep)."),
    KnobSpec("wire_precision", 0, 0, 3, int,
             "exposed-exchange ratio + spfft_wire_rung_declined_total",
             "Requested wire-compression rung for distributed exchanges "
             "(0=full, 1=f32, 2=bf16, 3=int8+per-stick scales); the "
             "plan's measured-error probe may decline down the ladder "
             "within wire_error_budget."),
    KnobSpec("wire_error_budget", 0.01, 1e-6, 1.0, float,
             "spfft_wire_rung_declined_total{reason=over_budget}",
             "Declared rel-l2 error budget for the compressed wire: a "
             "rung whose probe error exceeds it is REFUSED at plan "
             "build and the plan falls one rung down."),
)}

#: String-valued settings (paths) the numeric KnobSpec clamp cannot
#: carry. They live beside the knobs: hot-readable under the same
#: lock, round-tripped through the JSON artifact (under ``"paths"``),
#: but never exported as Prometheus gauges. ``plan_store_path`` ""
#: (the default) disables the disk plan tier unless the
#: ``SPFFT_TPU_PLAN_STORE`` env var names one; ``blob_store_url`` ""
#: disables the remote blob artifact tier unless
#: ``SPFFT_TPU_BLOB_STORE`` names one (http:// URL or a shared
#: directory — see ``net/blobstore.py``).
PATH_SETTINGS: Dict[str, str] = {"plan_store_path": "",
                                 "blob_store_url": ""}


def _counters():
    # late import: obs is cheap, but keeping it out of module import
    # keeps config importable from anywhere (dist.py, registry) without
    # ordering concerns
    from .. import obs
    return obs


class ServeConfig:
    """Typed, bounds-clamped, hot-swappable serving configuration.

    Reads (``config.batch_window`` or :meth:`get`) and writes
    (:meth:`set`) are lock-guarded, so a controller thread can retune a
    knob while the dispatcher reads it: the new value applies from the
    reader's next access. Every ACCEPTED change (value actually moved)
    is recorded as a decision — history entry, Prometheus counter/gauge
    and, when tracing is on, a ``control.retune`` instant on the
    ``control`` track.
    """

    def __init__(self, values: Optional[Dict] = None):
        self._lock = threading.Lock()
        #: guarded by _lock
        self._values: Dict[str, float] = {
            name: spec.default for name, spec in KNOB_SPECS.items()}
        self._paths: Dict[str, str] = dict(PATH_SETTINGS)  #: guarded by _lock
        #: guarded by _lock
        self._history: "collections.deque" = collections.deque(
            maxlen=HISTORY_LIMIT)
        self._seq = 0  #: guarded by _lock
        self._decisions_by_source: Dict[str, int] = {}  #: guarded by _lock
        if values:
            self.update(values, reason="initial values", source="init")

    # -- path settings -----------------------------------------------------
    @property
    def plan_store_path(self) -> str:
        with self._lock:
            return self._paths["plan_store_path"]

    @property
    def blob_store_url(self) -> str:
        with self._lock:
            return self._paths["blob_store_url"]

    def set_path(self, name: str, value: str) -> str:
        if name not in PATH_SETTINGS:
            raise InvalidParameterError(
                f"unknown path setting {name!r} "
                f"(settings: {sorted(PATH_SETTINGS)})")
        with self._lock:
            self._paths[name] = str(value or "")
            return self._paths[name]

    def paths(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._paths)

    # -- reading -----------------------------------------------------------
    def __getattr__(self, name: str):
        # only consulted when normal attribute lookup fails — i.e. for
        # knob names (internal attributes hit __dict__ first, so the
        # self._lock/self._values lookups below never recurse)
        if name.startswith("_") or name not in KNOB_SPECS:
            raise AttributeError(name)
        with self._lock:
            return self._values[name]

    def get(self, name: str):
        if name not in KNOB_SPECS:
            raise InvalidParameterError(f"unknown knob {name!r} "
                                        f"(knobs: {sorted(KNOB_SPECS)})")
        with self._lock:
            return self._values[name]

    def snapshot(self) -> Dict[str, float]:
        """Point-in-time copy of every knob value."""
        with self._lock:
            return dict(self._values)

    @staticmethod
    def spec(name: str) -> KnobSpec:
        spec = KNOB_SPECS.get(name)
        if spec is None:
            raise InvalidParameterError(f"unknown knob {name!r} "
                                        f"(knobs: {sorted(KNOB_SPECS)})")
        return spec

    @staticmethod
    def default(name: str):
        return ServeConfig.spec(name).default

    @staticmethod
    def bounds(name: str) -> Tuple[float, float]:
        spec = ServeConfig.spec(name)
        return (spec.lo, spec.hi)

    def decisions(self) -> List[Dict]:
        """The bounded decision history, oldest first (each entry:
        seq/knob/old/new/requested/clamped/reason/source)."""
        with self._lock:
            return list(self._history)

    def decision_count(self, source: Optional[str] = None) -> int:
        """Lifetime accepted-decision count (per ``source`` when given)
        — survives the bounded history window."""
        with self._lock:
            if source is None:
                return sum(self._decisions_by_source.values())
            return self._decisions_by_source.get(source, 0)

    # -- writing -----------------------------------------------------------
    def set(self, name: str, value, reason: str = "",
            source: str = "manual"):
        """Clamp ``value`` into ``name``'s declared bounds and apply it.
        Returns the CLAMPED value actually in effect. A write that does
        not move the knob records nothing; an accepted change records a
        decision everywhere an operator might look for it (history,
        ``spfft_control_*`` series, trace annotation)."""
        spec = self.spec(name)
        clamped = spec.clamp(value)
        with self._lock:
            old = self._values[name]
            if clamped == old:
                return old
            self._values[name] = clamped
            self._seq += 1
            requested = spec.kind(value)
            entry = {
                "seq": self._seq, "knob": name, "old": old,
                "new": clamped, "requested": requested,
                "clamped": clamped != requested,
                "reason": reason, "source": source,
            }
            self._history.append(entry)
            self._decisions_by_source[source] = \
                self._decisions_by_source.get(source, 0) + 1
        obs = _counters()
        obs.GLOBAL_COUNTERS.inc(
            "spfft_control_decisions_total", 1,
            help="Accepted control-plane knob changes.",
            knob=name, source=source)
        obs.GLOBAL_COUNTERS.set(
            "spfft_control_knob", clamped,
            help="Current value of each control-plane knob.", knob=name)
        if entry["clamped"]:
            obs.GLOBAL_COUNTERS.inc(
                "spfft_control_clamped_total", 1,
                help="Knob writes clamped into their declared bounds.",
                knob=name)
        obs.record_event("control.knob", knob=name, old=old,
                         new=clamped, reason=reason, source=source)
        if obs.active():
            obs.GLOBAL_TRACER.instant(
                "control.retune", cat="control", track="control",
                args={"knob": name, "old": old, "new": clamped,
                      "clamped": entry["clamped"], "reason": reason,
                      "source": source})
        return clamped

    def update(self, values: Dict, reason: str = "",
               source: str = "manual") -> Dict[str, float]:
        """Apply several knobs; unknown names raise before anything is
        written. Returns {name: clamped value in effect}."""
        for name in values:
            self.spec(name)  # validate all names first
        return {name: self.set(name, v, reason=reason, source=source)
                for name, v in values.items()}

    # -- persistence -------------------------------------------------------
    def to_artifact(self, provenance: Optional[Dict] = None) -> Dict:
        """The recommended-config artifact format the tuner emits and
        :meth:`load` consumes."""
        return {ARTIFACT_KEY: ARTIFACT_VERSION,
                "values": self.snapshot(),
                "paths": self.paths(),
                "provenance": provenance or {}}

    def save(self, path: str, provenance: Optional[Dict] = None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_artifact(provenance), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ServeConfig":
        """Load a recommended-config artifact. Unknown knobs in the
        file raise (a misspelt knob silently ignored is a tuning run
        thrown away); out-of-bounds values clamp, like every write."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as exc:
            raise InvalidParameterError(
                f"cannot read serve-config artifact {path!r}: {exc}")
        if not isinstance(payload, dict) \
                or payload.get(ARTIFACT_KEY) != ARTIFACT_VERSION:
            raise InvalidParameterError(
                f"{path!r} is not a spfft_tpu serve-config artifact "
                f"(want {ARTIFACT_KEY}={ARTIFACT_VERSION})")
        values = payload.get("values")
        if not isinstance(values, dict):
            raise InvalidParameterError(
                f"{path!r} carries no 'values' mapping")
        cfg = cls()
        cfg.update(values, reason=f"loaded from {path}", source="boot")
        paths = payload.get("paths")
        if paths is not None:
            if not isinstance(paths, dict):
                raise InvalidParameterError(
                    f"{path!r} 'paths' must be a mapping")
            for name, value in paths.items():
                cfg.set_path(name, value)
        return cfg

    @classmethod
    def boot(cls) -> "ServeConfig":
        """The executor's default config source: a fresh config, seeded
        from the ``SPFFT_TPU_SERVE_CONFIG`` artifact when that env var
        is set (the auto-tuner's output applied at boot). Each executor
        gets its OWN config object — a controller owns one executor's
        knobs, not the process's."""
        path = os.environ.get(CONFIG_ENV)
        if path:
            return cls.load(path)
        return cls()


#: Process-global config: the default the plans (``parallel/dist.py``'s
#: overlap_chunks and wire knobs) resolve through when no explicit value
#: is in play. Lazily boots from the env artifact.
_GLOBAL: Optional[ServeConfig] = None  #: guarded by _GLOBAL_LOCK
_GLOBAL_LOCK = threading.Lock()


def global_config() -> ServeConfig:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ServeConfig.boot()
        return _GLOBAL


def set_global_config(cfg: Optional[ServeConfig]) -> None:
    """Replace (or with None: reset, re-booting lazily) the process
    default — tests and embedding applications."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = cfg
