"""Persistent plan-artifact store: zero-cold-start serving (the port of
``spfft_tpu/serve/store.py``).

A fresh process pays plan construction from scratch: the index tables
(``build_index_plan``), the plan's device tables (the fused route's
compression CSR, the gather maps, the stick <-> plane maps) and, the
first time each kernel source runs, its ``nvcc`` build. The kernels'
libraries persist on their own (``build/torch_kernels/``, by source
digest); this module persists the plan half: a content-addressed
on-disk store of

    ``PlanSignature`` -> { the index plan, the plan's host tables
                           (:class:`~spfft_tpu_torch.plan.PlanTables`),
                           plan metadata }

that a REPLACEMENT PROCESS loads at boot instead of rebuilding. A warm
load reconstructs a :class:`~spfft_tpu_torch.plan.TransformPlan`
through :func:`~spfft_tpu_torch.plan.restore_plan` — no
``build_index_plan``, no table build, only the range checks of
``_check_restore`` and the copy of the tables to the device
(``PlanRegistry.get_or_build`` resolves with ``builds == 0``).

Artifact format (one file per signature,
``torch/artifacts/<key>.plan`` under the store's root):

    MAGIC line | 16-hex header length | JSON header | npz payload

* the header carries format + table-schema versions, the full
  canonical signature, reconstruction metadata (dims, precision, the
  route, the xy window, the fused declines, ``"aot": {}``, ``backend``:
  the torch device type the plan ran on) and the SHA-256 of the payload;
* the payload is an ``np.savez`` archive: ``value_indices`` /
  ``stick_keys`` / ``value_conj`` (the index plan) and each table of
  ``PlanTables.arrays`` as ``tab.<name>``.

The JAX package's AOT tier (``export_aot_blobs``, ``_install_aot``,
``AOT_ENV``) has no counterpart: this package has no serialised
executables (its kernels are built once per source), so its artifacts
carry tables only.

Safety contract (tests/test_torch_store.py): a poisoned artifact NEVER
loads — truncated/corrupt bytes, a format or table-schema version
mismatch, a payload checksum failure, an index digest that no longer
matches the stored tables, or a table ``_check_restore`` refuses
(``InvalidParameterError``: a length, type or index out of range) all
reject with a typed reason (``spfft_store_rejects_total{reason}``) and
the caller falls back to a clean rebuild. Writes are atomic (temp file
+ ``os.replace``).

One directory, or one blob store, can serve both packages. Both compute
the same ``PlanSignature``, and so the same key, for the same triplets;
this package keeps its own namespace: its files live under ``torch/``
(the JAX package's under ``artifacts/`` and ``requests/``), its blobs
under ``torch/art/`` and ``torch/req/`` (the JAX package's under
``art/`` and ``req/``), its artifacts start with their own :data:`MAGIC`
and its manifests carry their own :data:`MANIFEST_KEY`. So neither
package overwrites, garbage-collects or verifies the other's files; an
artifact of the other package met where this one looks (a copied file)
is refused as ``corrupt`` (its magic) and rebuilt, never loaded and
never a crash.

Request aliases (``torch/requests/<key>.json``) map the digest of a RAW
request (transform type, dims, precision, scaling, triplet bytes) to
its canonical artifact, so a fresh process resolves a request without
computing the signature.

CLI (``python -m spfft_tpu_torch.serve.store``): ``manifest`` records
the store's signatures for boot prewarm, ``prewarm`` warm-loads
everything into a fresh registry (``--compile``: and runs one
zero-valued backward per plan; optionally checking bit-exactness against
a recorded reference), ``gc`` enforces the byte cap, ``verify``
integrity-checks every artifact, ``seed`` builds one canonical workload
into the store. ``--device`` places the plans (default: the card).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import faults as _faults
from .. import obs as _obs
from ..errors import BlobStoreError, DeviceError, InvalidParameterError
from ..indexing import IndexPlan
from ..plan import PlanTables, TransformPlan, restore_plan
from ..timing import wait_ready
from ..types import Scaling, TransformType
from .registry import PLAN_MANIFEST_ENV, PlanSignature, index_digest

logger = logging.getLogger("spfft_tpu_torch")

#: Default store location for every registry in the process (see
#: ``PlanRegistry``); the config's ``plan_store_path`` (settable via
#: the boot artifact) takes precedence when set. The JAX package reads
#: the same variable: one directory serves both (module docstring).
PLAN_STORE_ENV = "SPFFT_TPU_PLAN_STORE"

#: Default REMOTE artifact tier (``net/blobstore.py``): an ``http://``
#: object-store URL or a shared directory. The config's
#: ``blob_store_url`` path setting takes precedence when set. The
#: remote tier sits BELOW the disk tier: a local miss consults it
#: through the same digest/version checks, a successful spill publishes
#: to it best-effort — an optimisation, never a correctness dependency.
BLOB_STORE_ENV = "SPFFT_TPU_BLOB_STORE"


#: Serializes live-manifest read/merge/replace cycles process-wide (the
#: env var names ONE file shared by every store object in the process).
_MANIFEST_LOCK = threading.Lock()

MAGIC = b"SPFFT-TPU-TORCH-PLAN-ARTIFACT\n"
#: Container format version: bumped on any change to the byte layout.
FORMAT_VERSION = 1
#: Table schema version: bumped when the tables of ``PlanTables`` change
#: (names, types or meaning) — an old artifact then rejects cleanly
#: instead of reconstructing garbage.
TABLE_SCHEMA = 1

#: This package's subdirectory of a store root, and its prefix in a
#: remote blob store.
LOCAL_DIR = "torch"
REMOTE_PREFIX = "torch/"

MANIFEST_KEY = "spfft_tpu_torch_plan_manifest"
MANIFEST_VERSION = 1
REQUEST_KEY = "spfft_tpu_torch_plan_request"

#: Typed rejection reasons (the ``reason`` label of
#: ``spfft_store_rejects_total``), the JAX package's.
REASON_CORRUPT = "corrupt"            # bytes/JSON/npz/checksum damage
REASON_VERSION = "version_mismatch"   # format or table-schema version
REASON_DIGEST = "digest_mismatch"     # stored index digest is stale
REASON_IO = "io"                      # unreadable file
REASON_INCOMPATIBLE = "incompatible"  # caller kwargs the artifact
                                      # cannot honour (rebuild instead)
REASON_DEGRADED = "degraded"          # spill skipped: memory-only tier

#: Store I/O degradation ladder: a TRANSIENT I/O error gets IO_RETRIES
#: bounded retries with IO_BACKOFF_S geometric backoff; a PERSISTENT
#: disk fault (ENOSPC, read-only or failing volume —
#: ``faults.PERSISTENT_DISK_ERRNOS``) flips the store to the memory-only
#: tier, re-probed every REPROBE_INTERVAL_S (doubling to
#: REPROBE_MAX_INTERVAL_S while the disk stays broken).
IO_RETRIES = 2
IO_BACKOFF_S = 0.05
REPROBE_INTERVAL_S = 30.0
REPROBE_MAX_INTERVAL_S = 480.0


# -- keys --------------------------------------------------------------------
def signature_key(sig: PlanSignature) -> str:
    """Content-derived artifact key: SHA-256 over the canonical
    signature fields (the index digest already summarises the sparse
    set, so equal keys mean interchangeable plans). The JAX package's
    key for the same signature."""
    h = hashlib.sha256()
    h.update("|".join(str(v) for v in dataclasses.astuple(sig)).encode())
    return h.hexdigest()


def request_key(transform_type, dim_x: int, dim_y: int, dim_z: int,
                triplets: np.ndarray, precision: str,
                scaling) -> str:
    """Digest of a RAW request (exact triplet bytes, caller order) —
    the alias key a fresh process can compute without building any
    index plan. Unlike the canonical signature it is representation
    sensitive (centered vs wrapped spellings get two aliases), mirroring
    the registry's raw-bytes memo."""
    arr = np.ascontiguousarray(np.asarray(triplets))
    h = hashlib.sha256()
    h.update(f"{TransformType(transform_type).value}|"
             f"{dim_x}|{dim_y}|{dim_z}|{precision}|"
             f"{Scaling(scaling).value}|{arr.dtype.str}|"
             f"{arr.shape}".encode())
    h.update(arr.tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class StoreReject(Exception):
    """Internal: one typed artifact rejection (reason + detail)."""

    reason: str
    detail: str

    def __str__(self) -> str:
        return f"{self.reason}: {self.detail}"


# -- artifact serialization --------------------------------------------------
def serialize_artifact(sig: PlanSignature, plan: TransformPlan) -> bytes:
    """The full artifact byte string for one (signature, plan) pair: the
    plan's :meth:`~spfft_tpu_torch.plan.TransformPlan.export_tables`
    (which raises the plan's sticky table-build failure) and its index
    plan."""
    tabs = plan.export_tables()
    p = plan.index_plan
    arrays: dict = {
        "value_indices": np.ascontiguousarray(p.value_indices),
        "stick_keys": np.ascontiguousarray(p.stick_keys),
    }
    if p.value_conj is not None:
        arrays["value_conj"] = np.ascontiguousarray(
            np.asarray(p.value_conj).astype(np.uint8))
    for name, table in tabs.arrays.items():
        arrays[f"tab.{name}"] = np.ascontiguousarray(table)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    header = {
        "format_version": FORMAT_VERSION,
        "table_schema": TABLE_SCHEMA,
        "signature": dataclasses.asdict(sig),
        "meta": {
            "transform_type": p.transform_type.value,
            "dim_x": p.dim_x, "dim_y": p.dim_y, "dim_z": p.dim_z,
            "centered": bool(p.centered),
            "precision": plan.precision,
            "num_values": p.num_values,
            "num_sticks": p.num_sticks,
            "fused": bool(tabs.fused),
            "fused_reasons": dict(tabs.fused_reasons),
            "split_x": None if tabs.split_x is None
            else [int(v) for v in tabs.split_x],
            "grid_w": int(tabs.grid_w),
            "tables": sorted(tabs.arrays),
            "aot": {},
            "backend": plan.device.type,
            "created_unix": time.time(),
        },
        "payload_sha256": hashlib.sha256(payload).hexdigest(),
        "payload_len": len(payload),
    }
    hbytes = json.dumps(header, sort_keys=True).encode()
    return b"".join([MAGIC, b"%016x\n" % len(hbytes), hbytes, payload])


def parse_artifact(data: bytes) -> Tuple[dict, dict]:
    """``(header, arrays)`` from artifact bytes, or raise
    :class:`StoreReject` with the typed reason. Every check the safety
    contract names runs here: magic (the JAX package's artifacts have
    another, and reject ``corrupt``), header parse, version match,
    payload checksum, npz parse, and the index-digest recomputation."""
    if not data.startswith(MAGIC):
        raise StoreReject(REASON_CORRUPT, "bad magic")
    off = len(MAGIC)
    try:
        hlen = int(data[off:off + 16], 16)
    except ValueError:
        raise StoreReject(REASON_CORRUPT, "bad header length")
    off += 17  # 16 hex chars + newline
    try:
        header = json.loads(data[off:off + hlen])
    except ValueError:
        raise StoreReject(REASON_CORRUPT, "header is not JSON")
    if not isinstance(header, dict):
        raise StoreReject(REASON_CORRUPT, "header is not a mapping")
    if header.get("format_version") != FORMAT_VERSION:
        raise StoreReject(
            REASON_VERSION,
            f"format_version {header.get('format_version')!r} != "
            f"{FORMAT_VERSION}")
    if header.get("table_schema") != TABLE_SCHEMA:
        raise StoreReject(
            REASON_VERSION,
            f"table_schema {header.get('table_schema')!r} != "
            f"{TABLE_SCHEMA}")
    payload = data[off + hlen:]
    if len(payload) != header.get("payload_len"):
        raise StoreReject(
            REASON_CORRUPT,
            f"payload is {len(payload)} bytes, header says "
            f"{header.get('payload_len')}")
    if hashlib.sha256(payload).hexdigest() != header.get("payload_sha256"):
        raise StoreReject(REASON_CORRUPT, "payload checksum mismatch")
    try:
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as exc:
        raise StoreReject(REASON_CORRUPT, f"payload unreadable: {exc!r}")
    for need in ("value_indices", "stick_keys"):
        if need not in arrays:
            raise StoreReject(REASON_CORRUPT, f"payload lacks {need}")
    # index-digest recomputation: the stored tables must still describe
    # the signature they claim to — a stale or swapped payload that
    # passes the checksum (e.g. a hand-edited artifact) rejects here
    # rather than loading a wrong-answer plan.
    ip = _index_plan_of(header, arrays)
    want = header.get("signature", {}).get("index_digest")
    got = index_digest(ip)
    if got != want:
        raise StoreReject(
            REASON_DIGEST, f"stored index digest {str(want)[:12]}... "
            f"but tables digest to {got[:12]}...")
    meta = header["meta"]
    if ip.num_values != meta.get("num_values") \
            or ip.num_sticks != meta.get("num_sticks"):
        raise StoreReject(REASON_CORRUPT, "table geometry inconsistent")
    return header, arrays


def _index_plan_of(header: dict, arrays: dict) -> IndexPlan:
    meta = header.get("meta", {})
    try:
        return IndexPlan(
            transform_type=TransformType(meta["transform_type"]),
            dim_x=int(meta["dim_x"]), dim_y=int(meta["dim_y"]),
            dim_z=int(meta["dim_z"]), centered=bool(meta["centered"]),
            value_indices=arrays["value_indices"],
            stick_keys=arrays["stick_keys"],
            value_conj=(arrays["value_conj"].astype(bool)
                        if "value_conj" in arrays else None))
    except (KeyError, TypeError, ValueError) as exc:
        raise StoreReject(REASON_CORRUPT, f"bad index metadata: {exc!r}")


def _plan_tables_of(header: dict, arrays: dict) -> PlanTables:
    """The artifact's :class:`~spfft_tpu_torch.plan.PlanTables`. Only
    their presence and metadata are checked here; the plan's
    ``_check_restore`` range-checks every table at the restore."""
    meta = header["meta"]
    try:
        names = list(meta["tables"])
        tables = {name: arrays[f"tab.{name}"] for name in names}
        split = meta.get("split_x")
        return PlanTables(
            arrays=tables,
            split_x=None if split is None else tuple(int(v) for v in split),
            grid_w=int(meta["grid_w"]), fused=bool(meta["fused"]),
            fused_reasons=dict(meta.get("fused_reasons") or {}))
    except (KeyError, TypeError, ValueError) as exc:
        raise StoreReject(REASON_CORRUPT, f"bad table payload: {exc!r}")


def _incompatible(tabs: PlanTables, kwargs: dict) -> Optional[str]:
    """Why the caller's plan kwargs ask for a route the artifact's
    tables were not built for, or None. ``fused=True`` asked of tables
    the two-kernel route was chosen for (not declined into) would have a
    fresh build make the fused tables; ``fused=False`` asked of fused
    tables, the two-kernel ones."""
    fused = kwargs.get("fused")
    if fused is True and not tabs.fused and not tabs.fused_reasons:
        return "fused=True but the tables were built for the two-kernel route"
    if fused is False and tabs.fused:
        return "fused=False but the tables were built for the fused route"
    return None


class PlanArtifactStore:
    """Content-addressed on-disk store of plan artifacts.

    ``root`` holds ``torch/artifacts/<signature key>.plan`` plus
    ``torch/requests/<request key>.json`` aliases (a JAX package's store
    may share ``root``: the module docstring). ``max_bytes`` bounds the
    artifacts' total size (``None`` resolves through the control
    plane's ``plan_store_max_bytes`` knob; 0 = unbounded): every save
    triggers an oldest-mtime GC sweep that never removes the artifact
    just written. All writes are atomic; concurrent writers of the
    same key are idempotent (same content, last ``os.replace`` wins).

    ``plan_kwargs`` are plan kwargs every load passes to
    :func:`~spfft_tpu_torch.plan.restore_plan` under the caller's own
    (``{"device": "cpu"}`` places restored plans on the host; by default
    they go to the card, as a built plan does).
    """

    def __init__(self, root: str, max_bytes: Optional[int] = None,
                 remote=None, plan_kwargs: Optional[dict] = None):
        self.root = str(root)
        self._max_bytes = max_bytes
        self._plan_kwargs = dict(plan_kwargs or {})
        self._lock = threading.Lock()
        # remote blob tier below disk: None resolves lazily through
        # the config/env (first use, not construction — the agent CLI
        # sets blob_store_url after stores may already exist); False
        # disables; a str/BlobStore pins it.
        self._remote_spec = remote
        self._remote_obj = None    #: guarded by _lock
        self._remote_ready = False  #: guarded by _lock
        self._hits = 0    #: guarded by _lock
        self._misses = 0  #: guarded by _lock
        self._spills = 0  #: guarded by _lock
        self._rejects: Dict[str, int] = {}  #: guarded by _lock
        #: guarded by _lock
        self._spill_threads: List[threading.Thread] = []
        self._degraded_reason: Optional[str] = None  #: guarded by _lock
        self._degraded_since = 0.0  #: guarded by _lock
        self._reprobe_at = 0.0      #: guarded by _lock
        #: guarded by _lock
        self._reprobe_interval = REPROBE_INTERVAL_S
        self._io_retries = 0        #: guarded by _lock
        os.makedirs(self._dir("artifacts"), exist_ok=True)
        os.makedirs(self._dir("requests"), exist_ok=True)

    def _dir(self, kind: str) -> str:
        return os.path.join(self.root, LOCAL_DIR, kind)

    def artifact_path(self, key: str) -> str:
        return os.path.join(self._dir("artifacts"), f"{key}.plan")

    def request_path(self, rkey: str) -> str:
        return os.path.join(self._dir("requests"), f"{rkey}.json")

    @property
    def max_bytes(self) -> int:
        if self._max_bytes is not None:
            return int(self._max_bytes)
        from ..control.config import global_config
        return int(global_config().plan_store_max_bytes)

    # -- counters ----------------------------------------------------------
    def _count(self, what: str, reason: Optional[str] = None) -> None:
        with self._lock:
            if what == "hit":
                self._hits += 1
            elif what == "miss":
                self._misses += 1
            elif what == "spill":
                self._spills += 1
            elif what == "reject":
                self._rejects[reason] = self._rejects.get(reason, 0) + 1
        _obs.record_store(what, reason)

    def stats(self) -> Dict:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "spills": self._spills,
                    "rejects": dict(self._rejects)}

    # -- degradation ladder ------------------------------------------------
    def _degrade(self, exc: BaseException) -> None:
        """Flip to the MEMORY-ONLY tier after a persistent disk fault:
        spills are skipped (the registry's LRU keeps serving), loads
        still attempt (per-artifact failures reject to clean rebuilds),
        ``health()`` reports degraded, and a periodic re-probe checks
        whether the volume recovered."""
        now = time.monotonic()
        with self._lock:
            fresh = self._degraded_reason is None
            self._degraded_reason = f"{type(exc).__name__}: {exc}"
            if fresh:
                self._degraded_since = now
                self._reprobe_interval = REPROBE_INTERVAL_S
            else:
                self._reprobe_interval = min(
                    self._reprobe_interval * 2, REPROBE_MAX_INTERVAL_S)
            self._reprobe_at = now + self._reprobe_interval
            interval = self._reprobe_interval
        _obs.GLOBAL_COUNTERS.set("spfft_store_degraded", 1.0)
        _obs.record_event("store.degrade",
                          reason=f"{type(exc).__name__}: {exc}",
                          interval_s=interval)
        logger.warning(
            "spfft_tpu_torch: plan-artifact store degraded to memory-only "
            "(%r) — spills disabled, re-probe in %.0f s", exc, interval)

    def _maybe_reprobe(self) -> None:
        """While degraded, probe the volume once per backoff interval:
        an atomic probe write that succeeds lifts the degradation; a
        failure doubles the interval (capped)."""
        with self._lock:
            if self._degraded_reason is None \
                    or time.monotonic() < self._reprobe_at:
                return
            # claim this probe slot so concurrent callers don't stack
            self._reprobe_at = time.monotonic() + self._reprobe_interval
        probe = os.path.join(self.root, LOCAL_DIR, ".reprobe")
        try:
            self._atomic_write_once(probe, b"probe")
            os.unlink(probe)
        except Exception:
            self._degrade_extend()
            _obs.GLOBAL_COUNTERS.inc("spfft_store_reprobes_total",
                                     outcome="failed")
            _obs.record_event("store.reprobe", outcome="failed")
            return
        with self._lock:
            self._degraded_reason = None
            self._degraded_since = 0.0
            self._reprobe_interval = REPROBE_INTERVAL_S
        _obs.GLOBAL_COUNTERS.set("spfft_store_degraded", 0.0)
        _obs.GLOBAL_COUNTERS.inc("spfft_store_reprobes_total",
                                 outcome="recovered")
        _obs.record_event("store.reprobe", outcome="recovered")
        logger.warning(
            "spfft_tpu_torch: plan-artifact store disk re-probe succeeded — "
            "memory-only degradation lifted, spills re-enabled")

    def _degrade_extend(self) -> None:
        with self._lock:
            self._reprobe_interval = min(
                self._reprobe_interval * 2, REPROBE_MAX_INTERVAL_S)
            self._reprobe_at = time.monotonic() + self._reprobe_interval

    @property
    def degraded(self) -> bool:
        """True while the store runs the memory-only tier."""
        with self._lock:
            return self._degraded_reason is not None

    def health(self) -> Dict:
        """Liveness snapshot for operators and the executor's
        ``health()``: ``state`` is ``"ok"`` or ``"degraded"``
        (memory-only tier after a persistent disk fault), with the
        triggering reason, how long it has been degraded, and when the
        next disk re-probe is due."""
        with self._lock:
            if self._degraded_reason is None:
                return {"state": "ok", "mode": "disk",
                        "io_retries": self._io_retries}
            now = time.monotonic()
            return {
                "state": "degraded",
                "mode": "memory-only",
                "reason": self._degraded_reason,
                "degraded_for_s": round(now - self._degraded_since, 3),
                "next_probe_in_s": round(
                    max(0.0, self._reprobe_at - now), 3),
                "io_retries": self._io_retries,
            }

    def _check(self, site: str) -> None:
        """Fault checkpoint that classifies like real I/O: an injected
        persistent disk fault (the ``enospc`` kind) degrades the store
        exactly as a genuine one surfacing from the filesystem would."""
        try:
            _faults.check_site(site)
        except OSError as exc:
            if _faults.is_persistent_disk_error(exc):
                self._degrade(exc)
            raise

    def _retry_io(self, op: str, fn):
        """Run one I/O operation under the degradation ladder: a
        transient ``OSError`` (EINTR, a brief NFS hiccup — anything
        outside :data:`~spfft_tpu_torch.faults.PERSISTENT_DISK_ERRNOS`) gets
        :data:`IO_RETRIES` bounded retries with geometric backoff; a
        persistent disk fault degrades the store to memory-only and
        re-raises for the caller's typed handling."""
        delay = IO_BACKOFF_S
        for attempt in range(IO_RETRIES + 1):
            try:
                return fn()
            except FileNotFoundError:
                raise  # a miss, not an I/O fault
            except OSError as exc:
                if _faults.is_persistent_disk_error(exc):
                    self._degrade(exc)
                    raise
                if attempt >= IO_RETRIES:
                    raise
                with self._lock:
                    self._io_retries += 1
                _obs.GLOBAL_COUNTERS.inc("spfft_store_io_retries_total",
                                         op=op)
                time.sleep(delay)
                delay *= 2

    # -- writing -----------------------------------------------------------
    def _atomic_write_once(self, path: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                _faults.check_site("store.fsync")
                os.fsync(f.fileno())
            _faults.check_site("store.replace")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _atomic_write(self, path: str, data: bytes) -> None:
        self._retry_io("write",
                       lambda: self._atomic_write_once(path, data))

    def save_plan(self, sig: PlanSignature, plan: TransformPlan,
                  triplets=None) -> str:
        """Serialize and atomically write one artifact (plus a request
        alias when the raw ``triplets`` are given). Returns the
        artifact key. While the store is DEGRADED (memory-only tier)
        the write is skipped — counted under
        ``spfft_store_rejects_total{reason=degraded}`` — unless the
        periodic re-probe just lifted the degradation."""
        t0 = time.perf_counter()
        self._check("store.spill")
        self._maybe_reprobe()
        key = signature_key(sig)
        if self.degraded:
            self._count("reject", REASON_DEGRADED)
            return key
        data = serialize_artifact(sig, plan)
        self._atomic_write(self.artifact_path(key), data)
        self._remote_publish(f"{REMOTE_PREFIX}art/{key}.plan", data)
        if triplets is not None:
            rkey = request_key(sig.transform_type, sig.dim_x, sig.dim_y,
                               sig.dim_z, triplets, sig.precision,
                               sig.scaling)
            alias = {REQUEST_KEY: 1, "artifact": key,
                     "signature": dataclasses.asdict(sig)}
            alias_bytes = json.dumps(alias).encode()
            self._atomic_write(self.request_path(rkey), alias_bytes)
            self._remote_publish(f"{REMOTE_PREFIX}req/{rkey}.json",
                                 alias_bytes)
        self._count("spill")
        _obs.record_compile("store_spill", time.perf_counter() - t0, t0,
                            key=key[:12], bytes=len(data))
        manifest = os.environ.get(PLAN_MANIFEST_ENV)
        if manifest:
            self._refresh_manifest(manifest, key, sig, plan, len(data))
        if self.max_bytes:
            self.gc(keep=key)
        return key

    def _refresh_manifest(self, path: str, key: str,
                          sig: PlanSignature, plan: TransformPlan,
                          nbytes: int) -> None:
        """Merge this spill into the live boot-prewarm manifest. Never
        fails the spill: a broken manifest file is a warning plus an
        ``io`` reject, and the next sweep (``python -m
        spfft_tpu_torch.serve.store manifest``) rebuilds it from the
        store."""
        entry = {
            "artifact": key,
            "signature": dataclasses.asdict(sig),
            "dims": [sig.dim_x, sig.dim_y, sig.dim_z],
            "num_values": plan.index_plan.num_values,
            "precision": sig.precision,
            "bytes": nbytes,
            "aot": [],
        }
        try:
            self.append_manifest_entry(path, entry)
            self._count("manifest_refresh")
        except (OSError, InvalidParameterError) as exc:
            self._count("reject", REASON_IO)
            logger.warning(
                "spfft_tpu_torch: live manifest refresh failed (%r)", exc)

    def spill_async(self, sig: PlanSignature, plan: TransformPlan,
                    triplets=None) -> threading.Thread:
        """Write-behind spill on a daemon thread (the registry's build
        path must not serialize MBs of tables on the serving thread).
        Failures are swallowed into a reject counter — a broken disk
        must never fail a successful build."""
        snapshot = None if triplets is None \
            else np.ascontiguousarray(np.asarray(triplets)).copy()

        def run():
            try:
                self.save_plan(sig, plan, snapshot)
            except Exception as exc:
                self._count("reject", REASON_IO)
                logger.warning(
                    "spfft_tpu_torch: plan-artifact spill failed (%r)", exc)

        th = threading.Thread(target=run, daemon=True,
                              name="spfft-plan-spill")
        with self._lock:
            self._spill_threads = [t for t in self._spill_threads
                                   if t.is_alive()]
            self._spill_threads.append(th)
        th.start()
        return th

    def drain(self) -> None:
        """Join all in-flight write-behind spills (tests, shutdown)."""
        with self._lock:
            threads = list(self._spill_threads)
        for th in threads:
            th.join()

    # -- the remote blob tier ----------------------------------------------
    def _remote_tier(self):
        """The resolved remote blob tier, or None. Resolution is lazy
        and cached: an explicit ``remote=`` ctor value wins, otherwise
        the control plane's ``blob_store_url`` path setting, otherwise
        the ``SPFFT_TPU_BLOB_STORE`` env var; empty everywhere means
        no remote tier."""
        with self._lock:
            if not self._remote_ready:
                self._remote_ready = True
                spec = self._remote_spec
                if spec is None:
                    from ..control.config import global_config
                    spec = global_config().blob_store_url \
                        or os.environ.get(BLOB_STORE_ENV, "")
                if spec is False:
                    spec = ""
                if isinstance(spec, str):
                    from ..net.blobstore import open_blobstore
                    self._remote_obj = open_blobstore(spec)
                else:
                    self._remote_obj = spec
            return self._remote_obj

    @staticmethod
    def _count_remote(op: str, outcome: str) -> None:
        _obs.GLOBAL_COUNTERS.inc("spfft_store_remote_total", op=op,
                                 outcome=outcome)

    def _remote_fetch(self, rkey: str,
                      write_through: Optional[str] = None
                      ) -> Optional[bytes]:
        """Read one blob from the remote tier: bytes on a hit, None on
        a miss OR any remote failure (the tier is best-effort — a
        wedged object store degrades to a local miss, counted, never
        raised through a plan load). A hit writes through to the local
        path so the next load is a disk read."""
        remote = self._remote_tier()
        if remote is None:
            return None
        try:
            data = remote.get(rkey)
        except BlobStoreError:
            self._count_remote("get", "error")
            return None
        if data is None:
            self._count_remote("get", "miss")
            return None
        self._count_remote("get", "hit")
        if write_through is not None and not self.degraded:
            try:
                self._atomic_write(write_through, data)
            except Exception:
                pass  # the local tier is sick; the bytes still serve
        return data

    def _remote_publish(self, rkey: str, data: bytes) -> None:
        """Best-effort put into the remote tier (the write-behind half
        of a spill): a failure is a counter, never a failed spill."""
        remote = self._remote_tier()
        if remote is None:
            return
        try:
            remote.put(rkey, data)
        except BlobStoreError:
            self._count_remote("put", "error")
            return
        self._count_remote("put", "ok")

    # -- reading -----------------------------------------------------------
    def _read_artifact(self, key: str):
        path = self.artifact_path(key)

        def read():
            with open(path, "rb") as f:
                return f.read()

        try:
            self._check("store.load")
            data = self._retry_io("read", read)
        except FileNotFoundError:
            # below the disk tier: the fleet's shared artifact set
            data = self._remote_fetch(f"{REMOTE_PREFIX}art/{key}.plan",
                                      write_through=path)
            if data is None:
                return None
        except OSError as exc:
            raise StoreReject(REASON_IO, f"cannot read {path}: {exc!r}")
        return parse_artifact(data)

    def load_key(self, key: str, plan_kwargs: Optional[dict] = None,
                 expect_sig: Optional[dict] = None):
        """Load artifact ``key`` into a live plan: ``(signature, plan)``
        on success, ``None`` on a miss or a typed rejection (counted;
        the caller rebuilds). ``expect_sig`` cross-checks the header
        signature against an alias/manifest entry."""
        t0 = time.perf_counter()
        try:
            got = self._read_artifact(key)
            if got is None:
                self._count("miss")
                return None
            header, arrays = got
            if expect_sig is not None \
                    and header.get("signature") != expect_sig:
                raise StoreReject(
                    REASON_DIGEST,
                    "artifact signature differs from the alias that "
                    "named it")
            try:
                sig = PlanSignature(**header["signature"])
            except TypeError as exc:
                raise StoreReject(REASON_CORRUPT,
                                  f"bad signature: {exc!r}")
            kwargs = dict(self._plan_kwargs, **(plan_kwargs or {}))
            tabs = _plan_tables_of(header, arrays)
            why = _incompatible(tabs, kwargs)
            if why is not None:
                # the caller asks for the other route's tables — a fresh
                # build would construct them; rebuild instead
                raise StoreReject(REASON_INCOMPATIBLE, why)
            ip = _index_plan_of(header, arrays)
            try:
                plan = restore_plan(ip, tabs, precision=sig.precision,
                                    **kwargs)
            except DeviceError:
                raise  # no card (or a kernel build): not the artifact's
            except Exception as exc:
                # a table _check_restore refuses (InvalidParameterError:
                # a length, type or index out of range) or any other
                # restore failure the artifact caused degrades to a
                # clean rebuild
                raise StoreReject(
                    REASON_CORRUPT, f"plan restore failed: {exc!r}")
            self._count("hit")
            _obs.record_compile(
                "store_load", time.perf_counter() - t0, t0,
                key=key[:12], aot_installed=0,
                dims=f"{sig.dim_x}x{sig.dim_y}x{sig.dim_z}",
                precision=sig.precision)
            return sig, plan
        except StoreReject as rej:
            self._count("reject", rej.reason)
            logger.warning(
                "spfft_tpu_torch: plan artifact %s rejected (%s) — "
                "rebuilding from scratch", key[:12], rej)
            return None

    def load_signature(self, sig: PlanSignature,
                       plan_kwargs: Optional[dict] = None):
        """Load by canonical signature (the registry's signature-keyed
        read-through)."""
        return self.load_key(signature_key(sig), plan_kwargs,
                             expect_sig=dataclasses.asdict(sig))

    def load_for_request(self, transform_type, dim_x: int, dim_y: int,
                         dim_z: int, triplets, precision: str,
                         scaling, plan_kwargs: Optional[dict] = None):
        """Resolve a RAW request through its alias: ``(signature,
        plan)`` or ``None``. This is the zero-index-build path — the
        only hashing is over the caller's triplet bytes."""
        rkey = request_key(transform_type, dim_x, dim_y, dim_z,
                           triplets, precision, scaling)
        path = self.request_path(rkey)
        try:
            with open(path) as f:
                alias = json.load(f)
        except FileNotFoundError:
            raw = self._remote_fetch(f"{REMOTE_PREFIX}req/{rkey}.json",
                                     write_through=path)
            if raw is None:
                self._count("miss")
                return None
            try:
                alias = json.loads(raw)
            except ValueError:
                self._count("reject", REASON_CORRUPT)
                return None
        except (OSError, ValueError):
            self._count("reject", REASON_CORRUPT)
            return None
        if not isinstance(alias, dict) or alias.get(REQUEST_KEY) != 1 \
                or not isinstance(alias.get("artifact"), str):
            self._count("reject", REASON_CORRUPT)
            return None
        return self.load_key(alias["artifact"], plan_kwargs,
                             expect_sig=alias.get("signature"))

    # -- maintenance -------------------------------------------------------
    def _artifact_files(self) -> List[Tuple[str, float, int]]:
        """(path, mtime, size) for every artifact, oldest first."""
        out = []
        adir = self._dir("artifacts")
        for name in os.listdir(adir):
            if not name.endswith(".plan"):
                continue
            path = os.path.join(adir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append((path, st.st_mtime, st.st_size))
        out.sort(key=lambda e: e[1])
        return out

    def bytes_in_use(self) -> int:
        return sum(size for _, _, size in self._artifact_files())

    def gc(self, max_bytes: Optional[int] = None,
           keep: Optional[str] = None) -> List[str]:
        """Evict oldest-mtime artifacts until the store fits in
        ``max_bytes`` (default: the configured cap; 0 = unbounded).
        ``keep`` names a key never evicted (the artifact just written).
        Dangling request aliases are swept too. Returns removed keys."""
        cap = self.max_bytes if max_bytes is None else int(max_bytes)
        removed = []
        if cap:
            files = self._artifact_files()
            total = sum(size for _, _, size in files)
            for path, _, size in files:
                if total <= cap:
                    break
                key = os.path.basename(path)[:-len(".plan")]
                if keep is not None and key == keep:
                    continue
                try:
                    os.unlink(path)
                except OSError:
                    continue
                total -= size
                removed.append(key)
                _obs.record_store("evict")
        if removed:
            live = {os.path.basename(p)[:-len(".plan")]
                    for p, _, _ in self._artifact_files()}
            rdir = self._dir("requests")
            for name in os.listdir(rdir):
                path = os.path.join(rdir, name)
                try:
                    with open(path) as f:
                        alias = json.load(f)
                    if alias.get("artifact") not in live:
                        os.unlink(path)
                except (OSError, ValueError):
                    continue
        return removed

    def verify(self) -> List[Dict]:
        """Integrity-check every artifact (full parse including the
        checksum and index-digest recomputation, no plan construction).
        Returns one report row per artifact."""
        rows = []
        for path, _, size in self._artifact_files():
            key = os.path.basename(path)[:-len(".plan")]
            row = {"key": key, "bytes": size, "ok": True}
            try:
                with open(path, "rb") as f:
                    header, _ = parse_artifact(f.read())
                meta = header["meta"]
                row.update({
                    "dims": [meta["dim_x"], meta["dim_y"],
                             meta["dim_z"]],
                    "num_values": meta["num_values"],
                    "precision": meta["precision"],
                    "aot": sorted(meta.get("aot") or ())})
            except StoreReject as rej:
                row.update({"ok": False, "reason": rej.reason,
                            "detail": rej.detail})
            except OSError as exc:
                row.update({"ok": False, "reason": REASON_IO,
                            "detail": repr(exc)})
            rows.append(row)
        return rows

    def manifest(self) -> Dict:
        """The boot-prewarm manifest: every loadable artifact's key and
        canonical signature (recorded by ``python -m
        spfft_tpu_torch.serve.store manifest``; consumed by
        ``PlanRegistry.warmup`` / ``warmup_manifest``)."""
        entries = []
        for path, _, size in self._artifact_files():
            key = os.path.basename(path)[:-len(".plan")]
            try:
                with open(path, "rb") as f:
                    header, _ = parse_artifact(f.read())
            except (StoreReject, OSError):
                continue
            meta = header["meta"]
            entries.append({
                "artifact": key,
                "signature": header["signature"],
                "dims": [meta["dim_x"], meta["dim_y"], meta["dim_z"]],
                "num_values": meta["num_values"],
                "precision": meta["precision"],
                "bytes": size,
                "aot": sorted(meta.get("aot") or ()),
            })
        return {MANIFEST_KEY: MANIFEST_VERSION, "store": self.root,
                "entries": entries}

    def write_manifest(self, path: str) -> Dict:
        m = self.manifest()
        self._atomic_write(path, json.dumps(m, indent=2).encode())
        return m

    def append_manifest_entry(self, path: str, entry: Dict) -> Dict:
        """Merge one entry into the live boot-prewarm manifest at
        ``path``: read (a missing file starts a fresh manifest),
        validate, dedupe on the artifact key (last write wins), atomic
        replace. In-process appenders serialize on the module-wide
        ``_MANIFEST_LOCK``; torn reads are impossible by the temp-file
        + ``os.replace`` write contract. An existing-but-invalid file
        raises ``InvalidParameterError`` rather than being clobbered.
        Returns the merged payload."""
        with _MANIFEST_LOCK:
            if os.path.exists(path):
                payload = load_manifest(path)
            else:
                payload = {MANIFEST_KEY: MANIFEST_VERSION,
                           "store": self.root, "entries": []}
            entries = [e for e in payload.get("entries", ())
                       if e.get("artifact") != entry.get("artifact")]
            entries.append(dict(entry))
            payload["entries"] = entries
            self._atomic_write(
                path, json.dumps(payload, indent=2).encode())
        return payload


# -- process-default store resolution ----------------------------------------
_DEFAULT_STORES: Dict[str, PlanArtifactStore] = {}  #: guarded by _DEFAULT_LOCK
_DEFAULT_LOCK = threading.Lock()


def default_store() -> Optional[PlanArtifactStore]:
    """The process-default store every ``PlanRegistry`` attaches when
    no explicit one is given: the control plane's ``plan_store_path``
    (boot artifact) or the ``SPFFT_TPU_PLAN_STORE`` env var; ``None``
    (the default) disables the disk tier. One store object per path."""
    from ..control.config import global_config
    path = global_config().plan_store_path \
        or os.environ.get(PLAN_STORE_ENV) or ""
    if not path:
        return None
    with _DEFAULT_LOCK:
        store = _DEFAULT_STORES.get(path)
        if store is None:
            store = _DEFAULT_STORES[path] = PlanArtifactStore(path)
        return store


def load_manifest(path: str) -> Dict:
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as exc:
        raise InvalidParameterError(
            f"cannot read plan manifest {path!r}: {exc}")
    if not isinstance(payload, dict) \
            or payload.get(MANIFEST_KEY) != MANIFEST_VERSION:
        raise InvalidParameterError(
            f"{path!r} is not a spfft_tpu_torch plan manifest "
            f"(want {MANIFEST_KEY}={MANIFEST_VERSION})")
    return payload


# -- CLI ---------------------------------------------------------------------
def _seed_triplets(dim: int, sparsity: float) -> np.ndarray:
    from ..utils.workloads import spherical_cutoff_triplets_stick_major
    radius = max(1, int((dim // 2) * min(max(sparsity, 0.01), 1.0)))
    return spherical_cutoff_triplets_stick_major(dim, radius)


def _host(t) -> np.ndarray:
    """A result tensor as a host numpy array."""
    return t.detach().cpu().numpy()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.serve.store",
        description="Persistent plan-artifact store maintenance")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default=None,
                        help="where the plans run: 'cpu' for the plain "
                             "PyTorch versions (default: the card)")

    s = sub.add_parser("seed", help="build one canonical workload into "
                                    "the store (the cold half)")
    s.add_argument("root")
    s.add_argument("--dim", type=int, default=24)
    s.add_argument("--transform", choices=["c2c", "r2c"], default="c2c")
    s.add_argument("--sparsity", type=float, default=0.5,
                   help="cutoff radius as a fraction of dim//2")
    s.add_argument("--precision", choices=["single", "double"],
                   default="single")
    s.add_argument("--reference", action="store_true",
                   help="record a backward-execution reference for "
                        "cross-process bit-exactness checks")
    s.add_argument("--no-fused", action="store_true",
                   help="build the two-kernel route's tables (the plan's "
                        "fused=False)")
    s.add_argument("--json", action="store_true")
    device_arg(s)

    m = sub.add_parser("manifest", help="record the store's signatures "
                                        "for boot prewarm")
    m.add_argument("root")
    m.add_argument("-o", "--output", default=None)

    w = sub.add_parser("prewarm", help="warm-load every artifact into a "
                                       "fresh registry")
    w.add_argument("root")
    w.add_argument("--manifest", default=None,
                   help="prewarm only the manifest's signatures "
                        "(default: everything in the store)")
    w.add_argument("--compile", action="store_true",
                   help="also execute one zero-valued backward per "
                        "plan and wait for it (the kernels built, the "
                        "first launches run)")
    w.add_argument("--check-reference", action="store_true",
                   help="re-resolve the seeded reference request and "
                        "assert builds==0 + bit-exact output")
    w.add_argument("--strict", action="store_true",
                   help="exit 1 when any artifact fails to load")
    w.add_argument("--json", action="store_true")
    device_arg(w)

    g = sub.add_parser("gc", help="evict oldest artifacts past the cap")
    g.add_argument("root")
    g.add_argument("--max-bytes", type=int, default=None)
    g.add_argument("--remote", action="store_true",
                   help="also sweep the remote blob tier's torch/req/ "
                        "journal to the blob_store_max_bytes knob "
                        "(or --max-bytes when given)")

    v = sub.add_parser("verify", help="integrity-check every artifact")
    v.add_argument("root")
    v.add_argument("--json", action="store_true")

    args = p.parse_args(argv)
    device = getattr(args, "device", None)
    store = PlanArtifactStore(
        args.root, plan_kwargs=None if device is None
        else {"device": device})

    if args.cmd == "seed":
        from .registry import PlanRegistry
        reg = PlanRegistry(store=store)
        tr = _seed_triplets(args.dim, args.sparsity)
        ttype = TransformType(args.transform)
        if ttype == TransformType.R2C:
            tr = tr[tr[:, 0] >= 0]
        kwargs = {"fused": False} if args.no_fused else {}
        if device is not None:
            kwargs["device"] = device
        t0 = time.perf_counter()
        sig, plan = reg.get_or_build(ttype, args.dim, args.dim,
                                     args.dim, tr,
                                     precision=args.precision, **kwargs)
        cold_ms = (time.perf_counter() - t0) * 1e3
        store.drain()
        rng = np.random.default_rng(20260804)
        vals = rng.standard_normal(
            (plan.index_plan.num_values, 2)).astype(
                np.float32 if args.precision == "single" else np.float64)
        t1 = time.perf_counter()
        out = plan.backward(vals)
        wait_ready(out)
        first_ms = (time.perf_counter() - t1) * 1e3
        out = _host(out)
        if args.reference:
            buf = io.BytesIO()
            np.savez(buf, triplets=tr, values=vals, backward=out,
                     dim=np.int64(args.dim))
            ref = {"transform": args.transform,
                   "precision": args.precision,
                   "fused": not args.no_fused,
                   "artifact": signature_key(sig)}
            local = os.path.join(store.root, LOCAL_DIR)
            store._atomic_write(os.path.join(local, "reference.npz"),
                                buf.getvalue())
            store._atomic_write(os.path.join(local, "reference.json"),
                                json.dumps(ref).encode())
        # cold_resolve_ms + first_backward_ms is what prewarm --compile's
        # warm_resolve_ms times in a fresh process over this store
        report = {"cmd": "seed", "cold_resolve_ms": round(cold_ms, 3),
                  "first_backward_ms": round(first_ms, 3),
                  "num_values": plan.index_plan.num_values,
                  "builds": reg.stats()["builds"],
                  "store": store.stats()}
        print(json.dumps(report) if args.json
              else json.dumps(report, indent=2))
        return 0

    if args.cmd == "manifest":
        out_path = args.output or os.path.join(args.root, LOCAL_DIR,
                                               "manifest.json")
        m = store.write_manifest(out_path)
        print(json.dumps({"cmd": "manifest", "path": out_path,
                          "entries": len(m["entries"])}))
        return 0

    if args.cmd == "prewarm":
        from .registry import PlanRegistry
        reg = PlanRegistry(store=store)
        # counter DELTAS across the prewarm (in-process callers — tests —
        # may carry prior compile events); kernel_build counts the
        # nvcc runs of kernel sources not yet built
        kinds = ("registry_build", "kernel_build", "store_load")
        base = {kind: _obs.GLOBAL_COUNTERS.get(
            "spfft_compile_events_total", kind=kind) for kind in kinds}
        load_s = _obs.GLOBAL_COUNTERS.get("spfft_compile_seconds_total",
                                          kind="store_load")
        t0 = time.perf_counter()
        if args.manifest:
            sigs = reg.warmup_manifest(args.manifest,
                                       compile=args.compile,
                                       strict=args.strict)
        else:
            entries = store.manifest()["entries"]
            sigs = reg.warmup(entries, compile=args.compile,
                              strict=args.strict)
        warm_ms = (time.perf_counter() - t0) * 1e3
        # of warm_resolve_ms: reading, hashing, parsing and restoring the
        # artifacts (the range checks, the tables' upload; the device's
        # start where the first upload meets it)
        load_ms = (_obs.GLOBAL_COUNTERS.get("spfft_compile_seconds_total",
                                            kind="store_load")
                   - load_s) * 1e3
        stats = reg.stats()
        compile_kinds = {
            kind: _obs.GLOBAL_COUNTERS.get(
                "spfft_compile_events_total", kind=kind) - base[kind]
            for kind in kinds}
        report = {"cmd": "prewarm", "loaded": len(sigs),
                  "warm_resolve_ms": round(warm_ms, 3),
                  "store_load_ms": round(load_ms, 3),
                  "builds": stats["builds"],
                  "store": store.stats(),
                  "compile_events": compile_kinds}
        ok = True
        if args.check_reference:
            local = os.path.join(store.root, LOCAL_DIR)
            with open(os.path.join(local, "reference.json")) as f:
                ref_meta = json.load(f)
            with np.load(os.path.join(local, "reference.npz")) as z:
                tr, vals, want = (z["triplets"], z["values"],
                                  z["backward"])
                dim = int(z["dim"])
            kwargs = {"fused": bool(ref_meta.get("fused", True))}
            t1 = time.perf_counter()
            sig, plan = reg.get_or_build(
                TransformType(ref_meta["transform"]), dim, dim, dim,
                tr, precision=ref_meta["precision"], **kwargs)
            report["reference_resolve_ms"] = round(
                (time.perf_counter() - t1) * 1e3, 3)
            got = _host(plan.backward(vals))
            report["reference_bit_exact"] = bool(
                np.array_equal(got, want))
            report["builds"] = reg.stats()["builds"]
            ok = ok and report["reference_bit_exact"] \
                and report["builds"] == 0
        if args.strict:
            ok = ok and report["builds"] == 0 \
                and not store.stats()["rejects"] \
                and len(sigs) > 0
        report["ok"] = bool(ok)
        print(json.dumps(report) if args.json
              else json.dumps(report, indent=2))
        return 0 if ok else 1

    if args.cmd == "gc":
        removed = store.gc(max_bytes=args.max_bytes)
        report = {"cmd": "gc", "removed": removed,
                  "bytes_in_use": store.bytes_in_use()}
        if args.remote:
            from ..control.config import global_config
            from ..net.blobstore import gc_blobstore
            tier = store._remote_tier()
            if tier is None:
                report["remote"] = {"error": "no remote blob tier "
                                             "configured"}
            else:
                cap = args.max_bytes if args.max_bytes is not None \
                    else global_config().blob_store_max_bytes
                report["remote"] = gc_blobstore(
                    tier, cap, prefix=f"{REMOTE_PREFIX}req/")
        print(json.dumps(report))
        return 0

    if args.cmd == "verify":
        rows = store.verify()
        bad = [r for r in rows if not r["ok"]]
        report = {"cmd": "verify", "artifacts": len(rows),
                  "bad": len(bad), "rows": rows}
        print(json.dumps(report) if args.json
              else json.dumps(report, indent=2))
        return 0 if not bad else 1

    return 2


if __name__ == "__main__":  # pragma: no cover - exercised by CLI tests
    raise SystemExit(main())
