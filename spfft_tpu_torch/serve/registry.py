"""Plan registry: a byte-aware bounded LRU of transform plans (the port
of ``spfft_tpu/serve/registry.py``).

A server handling heavy traffic sees the same few transform shapes over
and over, so plans live in a process-wide registry keyed by a CANONICAL
plan signature: the first request for a shape pays plan construction
(the index tables, the plan's device tables and, the first time a kernel
source runs in the process, its ``nvcc`` build), and every later request
reuses the live plan object.

The registry is bounded two ways: an entry-count cap and a BYTE budget
over each plan's resident device footprint
(:meth:`~spfft_tpu_torch.plan.TransformPlan.estimated_device_bytes`: its
tables, DFT matrices and twiddle tables). Eviction is oldest-use-first
and never evicts the entry being inserted.

``get_or_build`` resolves a REPEATED raw request shape without touching
``build_index_plan``: a bounded raw-bytes -> signature memo (exact byte
comparison against stored snapshots, see ``_memo_key``) short-circuits
straight to the resident plan. Concurrent first requests for one shape
serialise through a per-shape single-flight build, so a cold popular
shape builds exactly once under a thundering herd.

Signature canonicalisation: two requests address the same plan iff their
(dims, transform type, precision, scaling, device count) match AND their
sparse frequency sets match *in caller order* — the value array a caller
submits is positional, so order is part of the contract. The digest is
computed over the index plan's ``value_indices`` + ``stick_keys`` (and
the R2C ``value_conj`` mask), which encode exactly (storage triplet,
caller position): invariant to the triplets' representation (centered
and wrapped negative indices digest identically) but not to order.
:func:`index_digest` and :class:`PlanSignature` are the JAX package's,
bit for bit: the same triplets give the same digest and signature in
both packages.

The JAX plan kwargs ``use_pallas`` / ``device_double`` are this
package's ``fused`` / ``device`` (:class:`~spfft_tpu_torch.plan.
TransformPlan`); ``plan_kwargs`` pass through to the plan unchanged.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .. import faults as _faults
from .. import obs as _obs
from ..errors import InvalidParameterError
from ..indexing import IndexPlan, build_index_plan
from ..plan import TransformPlan
from ..timing import wait_ready
from ..types import Scaling, TransformType


#: Live boot-prewarm manifest (the store's and the executor's
#: ``PLAN_MANIFEST_ENV``, spelled once here so that neither imports the
#: other at import time): when set, every successful spill merges its
#: entry into the manifest at this path (read -> dedupe by artifact key
#: -> atomic replace), and a constructing executor prewarms from it. A
#: manifest of the JAX package at that path is refused, not merged
#: into.
PLAN_MANIFEST_ENV = "SPFFT_TPU_PLAN_MANIFEST"


def index_digest(index_plan: IndexPlan) -> str:
    """Canonical digest of one sparse frequency set in caller order
    (see module docstring for why order is part of the identity)."""
    h = hashlib.sha256()
    h.update(np.asarray(
        [index_plan.dim_x, index_plan.dim_y, index_plan.dim_z],
        np.int64).tobytes())
    h.update(index_plan.transform_type.value.encode())
    h.update(np.ascontiguousarray(
        index_plan.value_indices.astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(
        index_plan.stick_keys.astype(np.int64)).tobytes())
    if index_plan.value_conj is not None:
        # hermitian x < 0 folding: the conj mask changes execution
        # (boundary sign flips), so two plans differing only in it must
        # never share an artifact; unfolded plans hash exactly as before
        h.update(np.ascontiguousarray(
            index_plan.value_conj.astype(np.uint8)).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class PlanSignature:
    """Canonical, hashable identity of one servable transform: dims,
    sparse-index digest, transform type, precision, scaling and device
    count. Requests carrying equal
    signatures are guaranteed to be answerable by one plan object — the
    property the executor's same-signature batching relies on."""

    transform_type: str     # TransformType.value
    dim_x: int
    dim_y: int
    dim_z: int
    index_digest: str
    precision: str
    scaling: str            # Scaling.value
    device_count: int

    @classmethod
    def of_plan(cls, plan: TransformPlan,
                scaling: Scaling = Scaling.NONE) -> "PlanSignature":
        """The signature of an already-built local plan (used to seed a
        registry with externally constructed plans)."""
        p = plan.index_plan
        return cls(p.transform_type.value, p.dim_x, p.dim_y, p.dim_z,
                   index_digest(p), plan.precision,
                   Scaling(scaling).value, 1)


def signature_for(transform_type: TransformType, dim_x: int, dim_y: int,
                  dim_z: int, triplets,
                  precision: str = "single",
                  scaling: Scaling = Scaling.NONE,
                  device_count: int = 1) -> PlanSignature:
    """Compute the canonical signature for a raw triplet set without
    building a compiled plan (index-table construction only — numpy,
    milliseconds)."""
    ip = build_index_plan(TransformType(transform_type), dim_x, dim_y,
                          dim_z, np.asarray(triplets))
    return PlanSignature(TransformType(transform_type).value,
                         dim_x, dim_y, dim_z, index_digest(ip),
                         precision, Scaling(scaling).value,
                         int(device_count))


#: Default registry bounds, owned by the control config (KNOB_SPECS
#: "registry_max_bytes" / "registry_max_plans"): a handful of live
#: shapes is the realistic serving mix (SCF codes cycle 1-3
#: geometries). Constructor ``None`` resolves through the process
#: config (the boot artifact applies).
DEFAULT_MAX_BYTES = 2 * 1024 ** 3
DEFAULT_MAX_PLANS = 32


def _memo_key(transform_type: TransformType, dim_x: int, dim_y: int,
              dim_z: int, triplets: np.ndarray, precision: str,
              scaling: Scaling) -> tuple:
    """Scalar bucket key of a RAW request shape for the get_or_build
    memo. Deliberately EXCLUDES the triplet contents: candidate entries
    under one key are verified by exact byte comparison
    (``np.array_equal``) against a stored snapshot instead of a content
    digest — a vectorised memcmp is cheaper than sha256 over the same
    bytes and carries zero collision risk, which a truncated/cheap hash
    could not guarantee without exactly this comparison anyway. Unlike the
    canonical ``PlanSignature`` digest the memo is NOT representation
    invariant (centered and wrapped spellings of one sparse set occupy
    two memo slots) — both slots point at the SAME canonical
    signature."""
    return (TransformType(transform_type).value, dim_x, dim_y, dim_z,
            precision, Scaling(scaling).value, triplets.shape,
            triplets.dtype.str)


#: Byte budget for stored triplet snapshots in the get_or_build memo (the
#: JAX package's value). A set larger than the budget still keeps its
#: one entry: the newest memo key is never evicted (the 256^3 sphere's
#: 8,782,782 int32 triplets take 105 MB).
SIG_MEMO_MAX_BYTES = 64 * 1024 ** 2


class _BuildFlight:
    """One in-flight singleflight build: waiters block on ``done`` and
    read ``exc`` — a failed build releases every waiter at once with
    the builder's exception (never a wedge of serial re-builds), a
    successful one sends them back through the memo fast path."""

    __slots__ = ("done", "exc")

    def __init__(self):
        self.done = threading.Event()
        self.exc: BaseException = None


class PlanRegistry:
    """Thread-safe byte-aware bounded LRU of ``TransformPlan``s with
    hit/miss/eviction counters and explicit warmup/prefetch.

    ``get_or_build`` is the serving entry point: signature computed from
    the caller's triplets, registry consulted, plan constructed on miss.
    ``warmup`` prefetches a list of shapes before traffic arrives — with
    ``compile=True`` it also executes one zero-valued backward per plan
    (and waits for it), so the kernels' ``nvcc`` builds and the first
    launches happen at warmup time, not on the first real request.
    """

    def __init__(self, max_bytes: Optional[int] = None,
                 max_plans: Optional[int] = None,
                 store=None):
        if max_bytes is None or max_plans is None:
            from ..control.config import global_config
            cfg = global_config()
            if max_bytes is None:
                max_bytes = cfg.registry_max_bytes
            if max_plans is None:
                max_plans = cfg.registry_max_plans
        if max_plans < 1:
            raise InvalidParameterError("max_plans must be >= 1")
        # The persistent plan-artifact tier below the in-memory LRU
        # (spfft_tpu_torch.serve.store): a ``PlanArtifactStore``, a path
        # string, ``None`` (resolve the process default — the config's
        # plan_store_path or SPFFT_TPU_PLAN_STORE; usually disabled) or
        # ``False`` to force the tier off. Read-through on miss (a warm
        # load counts NO build), write-behind spill on build.
        if store is False:
            self._disk = None
        elif store is None:
            from .store import default_store
            self._disk = default_store()
        elif isinstance(store, str):
            from .store import PlanArtifactStore
            self._disk = PlanArtifactStore(store)
        else:
            self._disk = store
        self._max_bytes = int(max_bytes)
        self._max_plans = int(max_plans)
        #: guarded by _lock
        self._store: "collections.OrderedDict[PlanSignature, Tuple[TransformPlan, int]]" = \
            collections.OrderedDict()
        self._bytes = 0      #: guarded by _lock
        self._lock = threading.Lock()
        self._hits = 0       #: guarded by _lock
        self._misses = 0     #: guarded by _lock
        self._evictions = 0  #: guarded by _lock
        self._builds = 0     #: guarded by _lock
        #: weak references to the callables told of each eviction
        #: (:meth:`add_evict_listener`); guarded by _lock
        self._evict_listeners: List[weakref.ref] = []
        self._fast_hits = 0  #: guarded by _lock
        # raw-bytes -> canonical-signature memo (the get_or_build fast
        # path: a hit skips build_index_plan entirely). Keyed by the
        # scalar request tuple; each key holds (triplet snapshot, sig)
        # candidates verified by exact byte comparison. Bounded by
        # entry count AND snapshot bytes. Per-key singleflight build
        # locks serialise concurrent misses (one build per shape).
        #: guarded by _lock
        self._sig_memo: "collections.OrderedDict[tuple, List[Tuple[np.ndarray, PlanSignature]]]" = \
            collections.OrderedDict()
        self._sig_memo_cap = max(64, 4 * self._max_plans)
        self._sig_memo_bytes = 0  #: guarded by _lock
        self._build_flights: Dict[tuple, "_BuildFlight"] = {}  #: guarded by _lock
        self._build_failures = 0  #: guarded by _lock
        self._store_hits = 0      #: guarded by _lock
        self._store_misses = 0    #: guarded by _lock
        self._store_spills = 0    #: guarded by _lock

    @property
    def store(self):
        """The attached persistent artifact tier, or None."""
        return self._disk

    # -- lookup ------------------------------------------------------------
    def _get_memory(self,
                    signature: PlanSignature) -> Optional[TransformPlan]:
        """LRU-only lookup (counts hit/miss, no disk tier) — the
        in-memory half of :meth:`get`."""
        with self._lock:
            entry = self._store.get(signature)
            if entry is not None:
                self._hits += 1
                self._store.move_to_end(signature)
                return entry[0]
            self._misses += 1
            return None

    def get(self, signature: PlanSignature) -> Optional[TransformPlan]:
        """The plan for ``signature``, marking it most-recently-used —
        or None (counted as a miss). With a disk tier attached, an LRU
        miss falls through to the artifact store (a replacement process
        can answer signature-addressed traffic it has never built):
        a warm load inserts into the LRU and returns the plan; the
        counted miss stands (``store_hits`` disambiguates how the miss
        was then resolved)."""
        plan = self._get_memory(signature)
        if plan is not None:
            return plan
        if self._disk is None:
            return None
        loaded = self._disk.load_signature(signature)
        if loaded is None:
            return None
        sig, plan = loaded
        with self._lock:
            self._store_hits += 1
        self.put(sig, plan)
        return plan

    def signatures(self) -> List[PlanSignature]:
        """Snapshot of the in-memory tier's signatures, LRU order
        (oldest first), with no counter side effects."""
        with self._lock:
            return list(self._store)

    def __contains__(self, signature: PlanSignature) -> bool:
        with self._lock:  # no counter side effects
            return signature in self._store

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    # -- insertion ---------------------------------------------------------
    def put(self, signature: PlanSignature, plan: TransformPlan) -> None:
        """Insert (or refresh) a plan under ``signature`` and evict
        oldest-first past the byte/count budgets. The inserted entry
        itself is never evicted, so one over-budget plan still serves."""
        nbytes = int(plan.estimated_device_bytes())
        evicted = []
        with self._lock:
            old = self._store.pop(signature, None)
            if old is not None:
                self._bytes -= old[1]
            self._store[signature] = (plan, nbytes)
            self._bytes += nbytes
            while len(self._store) > 1 \
                    and (self._bytes > self._max_bytes
                         or len(self._store) > self._max_plans):
                sig, (_, b) = self._store.popitem(last=False)
                self._bytes -= b
                self._evictions += 1
                evicted.append(sig)
            listeners = [r() for r in self._evict_listeners] \
                if evicted else []
        for fn in listeners:
            if fn is not None:
                for sig in evicted:
                    fn(sig)

    def add_evict_listener(self, fn) -> None:
        """Call ``fn(signature)`` after each eviction (outside the
        registry's lock). Held weakly — a bound method keeps its object
        alive no longer than its owner does: the executor drops the
        staging buffers of an evicted signature this way."""
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        with self._lock:
            self._evict_listeners = [r for r in self._evict_listeners
                                     if r() is not None] + [ref]

    # lock: holds(_lock)
    def _fast_lookup_locked(self, memo_key, arr: np.ndarray):
        """Memoed (signature, plan) for a raw request, or None. Caller
        holds the lock. Candidates under the key are verified by exact
        byte comparison against their stored snapshot — the caller's
        array either IS the remembered request shape or it is not; no
        hash, no collisions. A verified hit whose plan was evicted falls
        through to the slow path (the index plan must be rebuilt to
        reconstruct the evicted TransformPlan)."""
        candidates = self._sig_memo.get(memo_key)
        if candidates is None:
            return None
        for stored, sig in candidates:
            if np.array_equal(arr, stored):
                self._sig_memo.move_to_end(memo_key)
                entry = self._store.get(sig)
                if entry is None:
                    return None
                self._hits += 1
                self._fast_hits += 1
                self._store.move_to_end(sig)
                return sig, entry[0]
        return None

    def _memoize(self, memo_key, arr: np.ndarray,
                 sig: PlanSignature) -> None:
        # snapshot the caller's bytes: later mutation of their array
        # must not corrupt the memo's ground truth
        stored = np.ascontiguousarray(arr).copy()
        with self._lock:
            candidates = self._sig_memo.setdefault(memo_key, [])
            if any(np.array_equal(stored, s) for s, _ in candidates):
                return  # raced builder already memoized these bytes
            candidates.append((stored, sig))
            self._sig_memo.move_to_end(memo_key)
            self._sig_memo_bytes += stored.nbytes
            while len(self._sig_memo) > 1 \
                    and (len(self._sig_memo) > self._sig_memo_cap
                         or self._sig_memo_bytes > SIG_MEMO_MAX_BYTES):
                _, dropped = self._sig_memo.popitem(last=False)
                self._sig_memo_bytes -= sum(s.nbytes
                                            for s, _ in dropped)

    def get_or_build(self, transform_type: TransformType, dim_x: int,
                     dim_y: int, dim_z: int, triplets,
                     precision: str = "single",
                     scaling: Scaling = Scaling.NONE,
                     **plan_kwargs) -> Tuple[PlanSignature, TransformPlan]:
        """Resolve (signature, plan) for a raw request shape, building
        and registering the plan on a miss. ``plan_kwargs`` pass through
        to ``TransformPlan`` (device, fused, donate_inputs,
        max_rel_error).

        Two hot-path properties (the serving layer's zero-rebuild
        contract): a REPEATED request shape resolves through a raw-bytes
        -> signature memo and never touches ``build_index_plan`` (which
        is milliseconds-to-seconds where the serving hot path is
        microseconds), and concurrent first requests for the SAME shape
        serialise through a per-shape singleflight lock so the index
        plan and TransformPlan build exactly once instead of N times
        (the dogpile). Index tables are built once and shared between
        the digest and the plan."""
        arr = np.asarray(triplets)
        memo_key = _memo_key(transform_type, dim_x, dim_y, dim_z, arr,
                             precision, scaling)
        while True:
            with self._lock:
                fast = self._fast_lookup_locked(memo_key, arr)
                if fast is None:
                    flight = self._build_flights.get(memo_key)
                    owner = flight is None
                    if owner:
                        flight = self._build_flights[memo_key] = \
                            _BuildFlight()
            if fast is not None:
                # surface a failed table build at resolution time
                # instead of on the first request (off the registry
                # lock)
                fast[1].check_build()
                return fast
            if owner:
                break
            # Follower: wait for the in-flight build, sharing its
            # OUTCOME either way. A failed build propagates the
            # builder's exception to every waiter at once (N waiters
            # behind one broken shape never serialise N failing
            # builds). A success loops back to the fast path (counted
            # as a hit); only a caller arriving AFTER the failed flight
            # retires retries the build fresh.
            flight.done.wait()
            if flight.exc is not None:
                raise flight.exc
        try:
            # the disk tier, consulted BEFORE any index-table work: a
            # warm artifact resolves the raw request through its alias
            # (triplet-byte digest), reconstructs the plan with zero
            # builds, and enters the LRU + memo like any other plan
            if self._disk is not None:
                loaded = self._disk.load_for_request(
                    transform_type, dim_x, dim_y, dim_z, arr,
                    precision, scaling, plan_kwargs=plan_kwargs)
                if loaded is not None:
                    sig, plan = loaded
                    with self._lock:
                        self._store_hits += 1
                    self.put(sig, plan)
                    self._memoize(memo_key, arr, sig)
                    return sig, plan
                with self._lock:
                    self._store_misses += 1
            t_build = time.perf_counter()
            _faults.check_site("registry.build")
            ip = build_index_plan(TransformType(transform_type), dim_x,
                                  dim_y, dim_z, arr)
            sig = PlanSignature(TransformType(transform_type).value,
                                dim_x, dim_y, dim_z, index_digest(ip),
                                precision, Scaling(scaling).value, 1)
            plan = self._get_memory(sig)
            if plan is None and self._disk is not None:
                # a DIFFERENT spelling of this sparse set may have
                # spilled the canonical artifact (the raw alias is
                # representation sensitive, the signature is not) —
                # kwargs-aware, unlike the public get() read-through
                loaded = self._disk.load_signature(
                    sig, plan_kwargs=plan_kwargs)
                if loaded is not None:
                    _, plan = loaded
                    with self._lock:
                        self._store_hits += 1
                    self.put(sig, plan)
            if plan is None:
                plan = TransformPlan(ip, precision=precision,
                                     **plan_kwargs)
                with self._lock:
                    self._builds += 1
                self.put(sig, plan)
                # compile observability: per-signature registry build
                # (index tables + plan construction) as span/counter
                _obs.record_compile(
                    "registry_build", time.perf_counter() - t_build,
                    t_build, dims=f"{dim_x}x{dim_y}x{dim_z}",
                    precision=precision, digest=sig.index_digest[:12])
                if self._disk is not None:
                    # write-behind: serialize off the serving thread
                    self._disk.spill_async(sig, plan, arr)
                    with self._lock:
                        self._store_spills += 1
            plan.check_build()
            self._memoize(memo_key, arr, sig)
            return sig, plan
        except BaseException as exc:
            flight.exc = exc
            with self._lock:
                self._build_failures += 1
            _obs.record_event("registry.build_failure",
                              error=type(exc).__name__)
            raise
        finally:
            with self._lock:
                self._build_flights.pop(memo_key, None)
            flight.done.set()

    # -- warmup ------------------------------------------------------------
    def warmup(self, specs: Iterable[dict], compile: bool = False,
               strict: bool = True) -> List[PlanSignature]:
        """Prefetch plans for a list of shape specs before traffic.

        Each spec is either a SHAPE spec (keys ``transform_type, dim_x,
        dim_y, dim_z, triplets`` plus optional ``precision``/``scaling``
        and plan kwargs — resolved through ``get_or_build``, so the disk
        tier applies) or an ARTIFACT spec (key ``artifact`` naming a
        store key, as recorded by ``python -m spfft_tpu_torch.serve.store
        manifest``; optional ``signature`` cross-check and
        ``plan_kwargs``; other keys are manifest metadata and ignored).
        An artifact spec that fails to load raises
        :class:`~spfft_tpu_torch.errors.PlanArtifactError` when ``strict``
        (the default — a prewarming replacement process must not
        silently join the pool half-warm) and is skipped otherwise.

        ``compile=True`` additionally runs one zero-valued backward per
        plan and waits for it (the JAX package's compile; here: the
        build of any kernel source not yet built in the process, and
        the first launches), so the first real request finds every
        kernel built.
        Returns the signatures in spec order (loaded ones only when
        ``strict=False``)."""
        from ..errors import PlanArtifactError
        sigs = []
        for spec in specs:
            spec = dict(spec)
            if "artifact" in spec:
                if self._disk is None:
                    raise InvalidParameterError(
                        "warmup spec names an artifact but the "
                        "registry has no plan store attached")
                loaded = self._disk.load_key(
                    spec["artifact"],
                    plan_kwargs=spec.get("plan_kwargs"),
                    expect_sig=spec.get("signature"))
                if loaded is None:
                    if strict:
                        raise PlanArtifactError(
                            f"plan artifact {spec['artifact'][:12]}... "
                            f"failed to load during warmup (see "
                            f"spfft_store_rejects_total for the "
                            f"reason)")
                    continue
                sig, plan = loaded
                self.put(sig, plan)
            else:
                ttype = spec.pop("transform_type")
                dims = (spec.pop("dim_x"), spec.pop("dim_y"),
                        spec.pop("dim_z"))
                triplets = spec.pop("triplets")
                sig, plan = self.get_or_build(ttype, *dims, triplets,
                                              **spec)
            # warmup is the blocking pre-traffic path: a doomed plan
            # fails HERE, not on the first request it would poison
            plan.check_build(wait=True)
            if compile:
                n = plan.index_plan.num_values
                wait_ready(plan.backward(
                    np.zeros((n, 2), np.float32)
                    if plan.precision == "single"
                    else np.zeros(n, np.complex128)))
            sigs.append(sig)
        return sigs

    def warmup_manifest(self, path: str, compile: bool = False,
                        strict: bool = True) -> List[PlanSignature]:
        """Boot prewarm from a recorded manifest (``python -m
        spfft_tpu_torch.serve.store manifest``): load every listed
        artifact into the LRU so a replacement process loads (and with
        ``compile``, runs) everything BEFORE taking traffic. Returns the loaded signatures."""
        from .store import load_manifest
        payload = load_manifest(path)
        return self.warmup(payload.get("entries", ()), compile=compile,
                           strict=strict)

    def prewarm_signatures(self, signatures: Iterable[PlanSignature],
                           strict: bool = True) -> int:
        """Pull a signature set warm through the read-through tiers
        (LRU -> disk -> remote blob) BEFORE taking traffic, without
        building anything (the joining half of a pod's membership, which
        hands a joiner the live signature set). Returns the count now
        resident. A signature no tier can answer raises
        :class:`~spfft_tpu_torch.errors.PlanArtifactError` when
        ``strict`` (a process must not join half-warm); distributed
        signatures (never serialized) simply skip."""
        from ..errors import PlanArtifactError
        warmed = 0
        for sig in signatures:
            if self.get(sig) is not None:
                warmed += 1
                continue
            if strict and sig.device_count <= 1:
                raise PlanArtifactError(
                    f"prewarm cannot resolve {sig!r} from any artifact "
                    f"tier (see spfft_store_rejects_total / "
                    f"spfft_blob_ops_total for why)")
        return warmed

    # -- counters ----------------------------------------------------------
    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def hit_rate(self) -> float:
        """hits / (hits + misses) over the registry's lifetime; 0.0
        before any lookup."""
        with self._lock:
            total = self._hits + self._misses
            return self._hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        """Counter snapshot for the metrics export."""
        with self._lock:
            total = self._hits + self._misses
            return {
                "plans": len(self._store),
                "bytes_in_use": self._bytes,
                "max_bytes": self._max_bytes,
                "max_plans": self._max_plans,
                "hits": self._hits,
                "misses": self._misses,
                "fast_hits": self._fast_hits,
                "evictions": self._evictions,
                "builds": self._builds,
                "build_failures": self._build_failures,
                "sig_memo_entries": sum(len(c) for c in
                                        self._sig_memo.values()),
                "sig_memo_bytes": self._sig_memo_bytes,
                "hit_rate": self._hits / total if total else 0.0,
                "store_hits": self._store_hits,
                "store_misses": self._store_misses,
                "store_spills": self._store_spills,
                "store_attached": self._disk is not None,
            }
