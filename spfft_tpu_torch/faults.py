"""Deterministic fault injection for the whole package (the port of
``spfft_tpu/faults.py``, the same scripts, sites and seeded draws).

A :class:`FaultPlan` is consulted at named check sites. Every name of
the JAX package's :data:`SITES` parses here, so one script drives both
packages; the sites this package checks today:

===================== ====================================================
site                  where it fires
===================== ====================================================
``plan.build``        a local plan's construction (its first check) and
                      its table build's half (the second check), which
                      the JAX package runs on a background thread: this
                      package builds its tables in the foreground, so a
                      firing second check is kept as the plan's sticky
                      ``TableBuildError``, raised by every execution
                      call and by ``check_build``
``kernel.launch``     a fused z kernel dispatch: once per public call
                      under the runtime demotion ladder, and once on the
                      first call of each executable the JAX package's
                      jit caches would compile (the trace-time check of
                      its ``fused_kernel.py``)
``exchange.pack``     the distributed pre-exchange stage, once per such
                      executable
``exchange.collective`` the exchange's move, once per such executable
``exchange.unpack``   the distributed post-exchange stage, likewise
``exchange.chunk``    each chunk of an overlapped exchange, likewise
``exchange.quantize`` the int8 wire rung's plan-build probe (a firing
                      check declines the rung, counted)
``obs.capture``       an incident bundle's write (typed, non-fatal)
===================== ====================================================

The serving, store and cluster sites wait for the modules that check
them.

A firing check raises :class:`InjectedFault` (or an
:class:`InjectedDiskFull` ``OSError`` for the ``enospc`` kind), which
flows through the same except-paths a real CUDA, runtime or disk
failure would. Faults fire two ways, both deterministic:

* **scripted** — ``"kernel.launch@3"`` fails the 3rd check of that site,
  ``"store.spill@1:enospc"`` makes the first spill hit a full disk,
  ``"device1@*:permanent"`` fails every check on pool device 1. Site
  counters are per site (and per device), so a script replays
  identically on an identical sequence of checks.
* **probabilistic** — ``rate`` per-check probability from a seeded
  ``random.Random(seed)``, optionally restricted to one ``scope`` site
  or ``"device:N"``: the same seed and check sequence give the same
  faults, in this package and in the JAX package alike.

Kinds: ``transient`` (default), ``permanent``, ``poison`` (permanent
and request-attributed), ``enospc`` (an ``OSError`` disk-full) and
``hang`` (sleeps ``hang_seconds``, then a transient fault).

``faults.arm(plan)`` installs a process-global plan that
:func:`check_site` consults (a no-op when nothing is armed: one global
read).

Classification: :func:`is_transient` reads an explicit ``transient``
attribute, then ``TimeoutError``, then the retryable status markers of
the JAX package's runtimes (:data:`TRANSIENT_MARKERS`) and of CUDA
(:data:`CUDA_TRANSIENT_MARKERS`: an out-of-memory error is retryable,
as ``RESOURCE_EXHAUSTED`` is); everything else is permanent.
:func:`attributes_device` charges the device for every error that is not
request-shaped, unless the error says otherwise: a kernel that fails to
BUILD (:class:`~spfft_tpu_torch.errors.KernelBuildError`) is tagged
``device_attributed = False``, so the fused kernels' demotion ladder
re-raises it instead of hiding it behind the two-kernel route.
"""

from __future__ import annotations

import errno
import random
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from .errors import (DuplicateIndicesError, InvalidIndicesError,
                     InvalidParameterError, ServeError)

#: The package's named fault-check sites. Dotted names group by
#: subsystem; the analyzer's fault-site checker enforces that every
#: ``check``/``check_site`` call uses a name declared here exactly
#: once, and that every declared site is checked somewhere.
SITES = (
    # serving executor
    "stage", "dispatch", "materialise", "loop",
    # plan lifecycle
    "plan.build",
    # registry
    "registry.build",
    # artifact store
    "store.load", "store.spill", "store.replace", "store.fsync",
    "store.aot",
    # fused z kernels
    "kernel.launch",
    # distributed exchange
    "exchange.pack", "exchange.collective", "exchange.unpack",
    "exchange.chunk", "exchange.quantize",
    # pod cluster
    "cluster.route", "cluster.rpc", "cluster.reconcile",
    "cluster.spmd_window",
    # wire transport + remote artifact tier (net/)
    "net.frame", "net.send", "net.recv", "net.accept",
    "blob.get", "blob.put",
    # lease-based membership + lane resurrection
    "net.heartbeat", "cluster.view", "cluster.readmit",
    # flight recorder: a failing incident-bundle write is typed and
    # non-fatal (recording must never take down serving)
    "obs.capture",
)

#: Substrings of runtime error text treated as transient — the
#: retryable subset of the gRPC status codes XLA/PJRT embed in
#: RuntimeError messages (device OOM under fragmentation, a briefly
#: unreachable device, a preempted collective).
TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE",
                     "DEADLINE_EXCEEDED", "ABORTED")

#: The retryable subset of CUDA's error text: the device's memory
#: exhausted (``torch.cuda.OutOfMemoryError``, or a kernel's allocation),
#: the counterpart of ``RESOURCE_EXHAUSTED``.
CUDA_TRANSIENT_MARKERS = ("CUDA out of memory", "CUDA error: out of memory")

#: Script kinds a :class:`FaultPlan` entry may carry.
KINDS = ("transient", "permanent", "poison", "enospc", "hang")


class InjectedFault(ServeError):
    """A failure raised by a :class:`FaultPlan` check. Carries the
    ``transient`` classification retry policies read and the
    ``device_attributed`` classification quarantine accounting reads
    (True by default — injection simulates infrastructure faults; the
    ``poison`` script kind injects request-attributed ones); otherwise
    handled exactly like any runtime failure."""

    def __init__(self, message: str, transient: bool = True,
                 device_attributed: bool = True):
        super().__init__(message)
        self.transient = transient
        self.device_attributed = device_attributed


class InjectedDiskFull(InjectedFault, OSError):
    """The ``enospc`` script kind: an injected disk-full failure. It IS
    an ``OSError`` with ``errno.ENOSPC`` so store code that branches on
    ``OSError``/errno (atomic writes, the memory-only degradation
    ladder) exercises its real handling, and it IS an
    :class:`InjectedFault` so harnesses can tell injected storms from
    genuine disk trouble. Permanent and not device-attributed — a full
    volume is neither retryable in place nor the accelerator's fault."""

    def __init__(self, message: str):
        InjectedFault.__init__(self, message, transient=False,
                               device_attributed=False)
        self.errno = errno.ENOSPC
        self.strerror = "No space left on device"


#: ``OSError`` errnos that mark a PERSISTENT disk problem — retrying
#: the same write cannot help; the store's degradation ladder flips to
#: memory-only instead. Everything else OSError-shaped (EINTR, EAGAIN,
#: a transient NFS hiccup) gets the bounded-retry rung first.
PERSISTENT_DISK_ERRNOS = (errno.ENOSPC, errno.EROFS, errno.EDQUOT,
                          errno.EIO)


def is_persistent_disk_error(exc: BaseException) -> bool:
    """Whether ``exc`` is an ``OSError`` whose errno marks the disk
    itself as unusable (:data:`PERSISTENT_DISK_ERRNOS`) — the trigger
    for the store's memory-only degradation, as opposed to a transient
    I/O error worth a bounded retry."""
    return (isinstance(exc, OSError)
            and getattr(exc, "errno", None) in PERSISTENT_DISK_ERRNOS)


def is_transient(exc: BaseException) -> bool:
    """Whether ``exc`` warrants the one bounded retry. An explicit
    ``transient`` attribute wins (injected faults, or any runtime that
    tags its errors); ``TimeoutError`` and runtime errors carrying a
    retryable status marker (:data:`TRANSIENT_MARKERS`,
    :data:`CUDA_TRANSIENT_MARKERS`) are transient; everything else —
    shape/type errors, poisoned payloads, logic bugs — is permanent."""
    tagged = getattr(exc, "transient", None)
    if tagged is not None:
        return bool(tagged)
    if isinstance(exc, TimeoutError):
        return True
    text = str(exc)
    return any(marker in text
               for marker in TRANSIENT_MARKERS + CUDA_TRANSIENT_MARKERS)


#: Exception types that indict the REQUEST, not the device it ran on:
#: shape/type/index errors (a poisoned payload fails identically on
#: every healthy device) and the library's own validation errors.
REQUEST_ERROR_TYPES = (TypeError, ValueError, IndexError, KeyError,
                       InvalidParameterError, InvalidIndicesError,
                       DuplicateIndicesError)


def attributes_device(exc: BaseException) -> bool:
    """Whether a failure should count against the DEVICE it ran on
    (quarantine accounting) rather than the request that triggered it.
    An explicit ``device_attributed`` attribute wins (injected faults,
    or a runtime that tags its errors); request-shaped errors
    (:data:`REQUEST_ERROR_TYPES` — a poisoned payload raises the same
    error on every healthy device) indict the request; everything else
    — CUDA launch errors, timeouts, unknown failures — charges the
    device. A kernel build failure carries ``device_attributed = False``
    (:class:`~spfft_tpu_torch.errors.KernelBuildError`): the code, not
    the card, is at fault."""
    tagged = getattr(exc, "device_attributed", None)
    if tagged is not None:
        return bool(tagged)
    if isinstance(exc, REQUEST_ERROR_TYPES):
        return False
    return True


_ENTRY_RE = re.compile(
    r"^(?P<site>[a-z][a-z0-9_.]*|device\d+)"
    r"@(?P<nth>\d+|\*)(?::(?P<kind>\w+))?$")


def _parse_entry(spec: str) -> Tuple[str, Optional[int], str]:
    """One script entry ``SITE@N[:KIND]`` -> (counter key, nth-or-None
    for always, kind). SITE is a check site or ``deviceK``; ``N`` is
    the 1-based call index of that counter, ``*`` fires on every call;
    KIND is ``transient`` (default), ``permanent`` (both
    device-attributed), ``poison`` (permanent AND request-attributed —
    simulates a bad payload, exercising the quarantine-attribution
    seam), ``enospc`` (an ``OSError`` disk-full, exercising the store's
    degradation ladder) or ``hang`` (sleeps ``hang_seconds`` before a
    transient fault, exercising the execute watchdog)."""
    m = _ENTRY_RE.match(spec.strip())
    if not m:
        raise InvalidParameterError(
            f"bad fault-script entry {spec!r} (want SITE@N[:KIND], e.g. "
            f"'dispatch@3', 'store.spill@1:enospc', "
            f"'device1@*:permanent')")
    site = m.group("site")
    if site not in SITES and not site.startswith("device"):
        raise InvalidParameterError(
            f"unknown fault site {site!r} (sites: {SITES} or deviceK)")
    nth = None if m.group("nth") == "*" else int(m.group("nth"))
    if nth is not None and nth < 1:
        raise InvalidParameterError("fault-script call index is 1-based")
    kind = m.group("kind") or "transient"
    if kind not in KINDS:
        raise InvalidParameterError(
            f"fault kind must be one of {'|'.join(KINDS)}, got {kind!r}")
    return site, nth, kind


def _record(metric: str, **labels) -> None:
    """Best-effort counter recording; import is lazy because obs is a
    heavier import than this leaf module and faults must stay
    importable everywhere (including from obs-free unit tests)."""
    try:
        from .obs import GLOBAL_COUNTERS
    except Exception:  # pragma: no cover - circular/partial import
        return
    GLOBAL_COUNTERS.inc(metric, **labels)


def _journal(site: str, fire: str) -> None:
    """Best-effort flight-recorder journal entry for a fired fault
    (same lazy-import discipline as :func:`_record`)."""
    try:
        from .obs import record_event
    except Exception:  # pragma: no cover - circular/partial import
        return
    record_event("fault.fired", site=site, kind=fire)


class FaultPlan:
    """Deterministic fault-injection oracle, shared package-wide.

    ``script`` is an iterable of ``SITE@N[:KIND]`` entries (or one
    comma-separated string); ``rate`` adds seeded per-check transient
    faults, optionally restricted to ``scope`` (a site name or
    ``"device:N"``); ``hang_seconds`` is how long a ``hang`` entry
    wedges its caller before failing. Thread-safe: checks run on
    dispatcher, table-build and spill threads; stats reads come from anywhere.
    """

    def __init__(self, rate: float = 0.0, seed: int = 0,
                 scope: Optional[str] = None, script=None,
                 hang_seconds: float = 30.0):
        if not 0.0 <= rate <= 1.0:
            raise InvalidParameterError("fault rate must be in [0, 1]")
        if scope is not None:
            key = scope.replace("device:", "device")
            if key not in SITES and not (key.startswith("device")
                                         and key[6:].isdigit()):
                raise InvalidParameterError(
                    f"bad fault scope {scope!r} (sites: {SITES} or "
                    f"'device:N')")
            scope = key
        if isinstance(script, str):
            script = [s for s in script.split(",") if s.strip()]
        if hang_seconds < 0:
            raise InvalidParameterError("hang_seconds must be >= 0")
        self._rate = float(rate)
        self._rng = random.Random(seed)  #: guarded by _lock
        self._scope = scope
        self._script: List[Tuple[str, Optional[int], str]] = \
            [_parse_entry(s) for s in (script or [])]
        self._hang_seconds = float(hang_seconds)
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}  #: guarded by _lock
        #: guarded by _lock
        self._fired: Dict[str, int] = {kind: 0 for kind in KINDS}
        self._fired_by_site: Dict[str, int] = {}  #: guarded by _lock

    def _in_scope(self, site: str, dev_key: Optional[str]) -> bool:
        if self._scope is None:
            return site != "loop"  # rate faults never crash the loop
        return self._scope == site or self._scope == dev_key

    def check(self, site: str, device: Optional[int] = None) -> None:
        """One pipeline checkpoint: increments the ``site`` counter (and
        the ``deviceN`` counter when a pool device index is given) and
        raises :class:`InjectedFault` (or :class:`InjectedDiskFull`)
        when a script entry or the seeded rate says this call fails.
        No-op otherwise."""
        with self._lock:
            n = self._calls[site] = self._calls.get(site, 0) + 1
            dev_key = dn = None
            if device is not None:
                dev_key = f"device{device}"
                dn = self._calls[dev_key] = self._calls.get(dev_key,
                                                           0) + 1
            fire = None
            for key, nth, kind in self._script:
                hit = (key == site and (nth is None or nth == n)) or \
                      (key == dev_key and (nth is None or nth == dn))
                if hit:
                    fire = kind
                    break
            if fire is None and self._rate > 0.0 \
                    and self._in_scope(site, dev_key):
                if self._rng.random() < self._rate:
                    fire = "transient"
            if fire is None:
                return
            self._fired[fire] += 1
            self._fired_by_site[site] = \
                self._fired_by_site.get(site, 0) + 1
            hang = self._hang_seconds if fire == "hang" else 0.0
        _record("spfft_faults_injected_total", site=site, kind=fire)
        _journal(site, fire)
        where = site if device is None else f"{site} (device {device})"
        if fire == "enospc":
            raise InjectedDiskFull(f"injected disk-full at {where}")
        if hang:
            time.sleep(hang)  # outside the lock: only the caller wedges
        raise InjectedFault(f"injected {fire} fault at {where}",
                            transient=fire in ("transient", "hang"),
                            device_attributed=fire != "poison")

    def stats(self) -> Dict:
        """Counter snapshot: checks seen and faults fired, per site."""
        with self._lock:
            return {
                "rate": self._rate,
                "scope": self._scope,
                "script_entries": len(self._script),
                "checks": dict(self._calls),
                "fired_transient": self._fired["transient"],
                "fired_permanent": self._fired["permanent"],
                "fired_poison": self._fired["poison"],
                "fired_enospc": self._fired["enospc"],
                "fired_hang": self._fired["hang"],
                "fired_by_site": dict(self._fired_by_site),
            }


#: The process-global ambient plan :func:`check_site` consults. Plain
#: attribute read on the hot path; writes go through :func:`arm` /
#: :func:`disarm` (tests and the chaos harness are the only writers).
_AMBIENT: Optional[FaultPlan] = None
_AMBIENT_LOCK = threading.Lock()


def arm(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` as the process-global ambient fault plan that
    :func:`check_site` consults (``None`` disarms). Subsystems without
    an injection API of their own — plan builds, the store, the
    registry, fused kernels, the exchange — fire through this hook."""
    global _AMBIENT
    with _AMBIENT_LOCK:
        _AMBIENT = plan
    try:
        from .obs import GLOBAL_COUNTERS
    except Exception:  # pragma: no cover - circular/partial import
        return
    GLOBAL_COUNTERS.set("spfft_faults_armed",
                        0.0 if plan is None else 1.0)


def disarm() -> None:
    """Remove the ambient fault plan (idempotent)."""
    arm(None)


def armed() -> Optional[FaultPlan]:
    """The currently armed ambient plan, if any."""
    return _AMBIENT


def check_site(site: str, device: Optional[int] = None) -> None:
    """Package-wide fault checkpoint: consult the ambient
    :class:`FaultPlan` if one is armed, else no-op. This is the ONE
    line a subsystem adds per seam; cost when disarmed is a global
    read and an ``is not None``."""
    plan = _AMBIENT
    if plan is not None:
        plan.check(site, device)
