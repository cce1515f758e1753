"""Lease-based, epoch-fenced pod membership (the port of
``spfft_tpu/net/membership.py``: the same election, the same canonical
view encoding and signature, so a view signed by either package verifies
in the other).

Two liveness gaps a pod must close: membership held by each frontend
alone (two frontends could hold contradictory views of the same pod),
and a lane marked dead staying dead forever. This module is the
convergence point both close through:

* **Leases** — every agent holds a time-bounded lease it renews with
  a lightweight ``heartbeat`` RPC; the ack carries the coordinator's
  full signed view, which the follower adopts each beat (elections
  run over real per-host states, never a states-less roster). A lease
  that stops renewing walks the expiry ladder ``alive -> suspected ->
  probed -> evicted`` at multiples of ``lease_ttl_ms`` past its last
  renewal; no state is removed on a single missed beat. Members
  registered statically via :meth:`ViewCoordinator.ensure` (loopback
  lanes nothing heartbeats) hold no lease and never expire.
* **Epochs** — a single :class:`ViewCoordinator` (the lowest alive
  host id; deterministic, no Raft — leases + fencing suffice at pod
  scale) bumps a monotonic view epoch on EVERY membership change and
  serves the signed view over the ``view`` RPC. Frontends stamp the
  epoch on routed work; agents reject anything older than their view
  with the typed transient
  :class:`~spfft_tpu_torch.errors.StaleEpochError` — the sender refetches
  the view and retries, so a partitioned frontend can never
  split-brain the pod.
* **Election** — :func:`elect_coordinator` is a pure function of the
  view (lowest alive host id), so every node that holds the same view
  names the same coordinator; a dead coordinator is detected by its
  heartbeat targets (failure streak), locally suspected, and the
  next-lowest alive host promotes itself with an epoch bump.

:class:`MembershipNode` is one agent's half: a roster + cached view,
a heartbeat sender (:meth:`MembershipNode.tick`), and an embedded
coordinator that activates when this host is elected.
:class:`ViewCoordinator` is also used standalone by ``PodFrontend``
for loopback pods (the frontend is trivially the coordinator of an
in-process pod) and shared between frontends in tests.

Views are signed: HMAC-SHA256 over the canonical JSON encoding when
``SPFFT_TPU_NET_SECRET`` is set, a plain SHA-256 integrity digest
otherwise; a view whose signature does not verify is rejected with
the permanent :class:`~spfft_tpu_torch.errors.NetAuthError` and counted
``spfft_membership_views_total{outcome="bad_sig"}``.

Fault sites: ``net.heartbeat`` fires on each renewal (sender wire
call and coordinator handling), ``cluster.view`` on serving/adopting
a view. Counters: ``spfft_membership_epoch{node}``,
``spfft_membership_transitions_total{host,to}``,
``spfft_membership_heartbeats_total{outcome}``,
``spfft_membership_views_total{outcome}``,
``spfft_cluster_stale_epoch_total{node}``.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import json
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import faults as _faults
from .. import obs as _obs
from ..errors import (InvalidParameterError, NetAuthError,
                      NetProtocolError, StaleEpochError)

#: Ladder states, rung order. ``evicted`` members stay in the view
#: (tombstoned) so late frontends learn the eviction instead of
#: mistaking the host for never-seen.
ALIVE = "alive"
SUSPECTED = "suspected"
PROBED = "probed"
EVICTED = "evicted"
LADDER = (ALIVE, SUSPECTED, PROBED, EVICTED)
_RANK = {s: i for i, s in enumerate(LADDER)}

#: Ladder timing as multiples of the lease TTL past the last renewal:
#: suspect after one full TTL, escalate to probed at 1.5x, evict at
#: 2.5x — an agent that restarts inside ~2.5 TTLs rejoins without
#: ever having been evicted.
SUSPECT_AFTER = 1.0
PROBE_AFTER = 1.5
EVICT_AFTER = 2.5

#: Consecutive heartbeat failures before a node locally suspects its
#: coordinator and re-elects.
COORD_FAIL_STREAK = 3

_UNSET = object()


def _lease_ttl_s() -> float:
    from ..control.config import global_config
    return global_config().lease_ttl_ms / 1e3


def _secret() -> Optional[bytes]:
    from .frame import net_secret
    return net_secret()


def _count_hb(outcome: str) -> None:
    _obs.GLOBAL_COUNTERS.inc("spfft_membership_heartbeats_total",
                             outcome=outcome)


def _count_view(outcome: str) -> None:
    _obs.GLOBAL_COUNTERS.inc("spfft_membership_views_total",
                             outcome=outcome)


def _gauge_epoch(node: str, epoch: int) -> None:
    _obs.GLOBAL_COUNTERS.set("spfft_membership_epoch", epoch,
                             node=node)


def elect_coordinator(members: Dict[str, str]) -> Optional[str]:
    """The deterministic coordinator of a view: the LOWEST alive host
    id (string sort — host ids are operator-chosen names like ``h0``).
    Every node holding the same view elects the same coordinator; no
    ballots."""
    alive = sorted(h for h, state in members.items()
                   if state == ALIVE)
    return alive[0] if alive else None


class MembershipView:
    """One immutable, signed snapshot of the pod: ``epoch``,
    ``coordinator``, and per-host ``{"state", "address"}`` rows."""

    __slots__ = ("epoch", "coordinator", "members", "signature")

    def __init__(self, epoch: int, coordinator: Optional[str],
                 members: Dict[str, Dict], signature: str = ""):
        self.epoch = int(epoch)
        self.coordinator = coordinator
        self.members = {str(h): {"state": str(m["state"]),
                                 "address": m.get("address")}
                        for h, m in members.items()}
        self.signature = signature

    def states(self) -> Dict[str, str]:
        return {h: m["state"] for h, m in self.members.items()}

    def _canonical(self) -> bytes:
        return json.dumps(
            {"epoch": self.epoch, "coordinator": self.coordinator,
             "members": self.members},
            sort_keys=True).encode("utf-8")

    def signed(self, secret: Optional[bytes] = None
               ) -> "MembershipView":
        """A copy carrying the view signature: HMAC-SHA256 under the
        pod secret, else a SHA-256 integrity digest."""
        body = self._canonical()
        if secret:
            sig = _hmac.new(secret, body, hashlib.sha256).hexdigest()
        else:
            sig = hashlib.sha256(body).hexdigest()
        return MembershipView(self.epoch, self.coordinator,
                              self.members, signature=sig)

    def verify(self, secret: Optional[bytes] = None) -> bool:
        return _hmac.compare_digest(
            self.signed(secret).signature, self.signature or "")

    def to_wire(self) -> dict:
        return {"epoch": self.epoch, "coordinator": self.coordinator,
                "members": self.members,
                "signature": self.signature}

    @classmethod
    def from_wire(cls, wire: dict) -> "MembershipView":
        try:
            return cls(int(wire["epoch"]), wire.get("coordinator"),
                       dict(wire["members"]),
                       signature=str(wire.get("signature", "")))
        except (KeyError, TypeError, ValueError) as exc:
            raise NetProtocolError(
                f"malformed membership view: {exc!r}") from exc


class _Member:
    """``renewed is None`` means the member holds NO lease (it was
    statically registered via :meth:`ViewCoordinator.ensure` — a
    loopback/frontend-embedded lane nothing heartbeats) and is exempt
    from lease expiry; the first heartbeat converts it to a leased
    member."""

    __slots__ = ("state", "address", "renewed")

    def __init__(self, state: str, address: Optional[str],
                 renewed: Optional[float]):
        self.state = state
        self.address = address
        self.renewed = renewed


class ViewCoordinator:
    """The pod's single membership authority: a lease table plus the
    monotonic view epoch. Thread-safe; a frontend embeds one for
    loopback pods, an agent's :class:`MembershipNode` activates one
    when elected."""

    def __init__(self, host: str, clock: Callable[[], float] = None,
                 lease_ttl_s: Optional[float] = None,
                 secret=_UNSET):
        self.host = str(host)
        self._clock = clock or time.monotonic
        self._ttl = lease_ttl_s
        self._secret = _secret() if secret is _UNSET else secret
        self._lock = threading.Lock()
        self._epoch = 1  #: guarded by _lock
        self._members: Dict[str, _Member] = {}  #: guarded by _lock
        self._members[self.host] = _Member(ALIVE, None, self._clock())

    # lock: holds(_lock)
    def _bump(self, host: str, to: str) -> None:
        self._epoch += 1
        _obs.GLOBAL_COUNTERS.inc(
            "spfft_membership_transitions_total", host=host, to=to)
        _obs.record_event("membership.transition", host=host, to=to,
                          epoch=self._epoch)
        _gauge_epoch(self.host, self._epoch)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def ttl(self) -> float:
        return self._ttl if self._ttl is not None else _lease_ttl_s()

    def ensure(self, host: str, address: Optional[str] = None) -> None:
        """Register ``host`` alive if it is not already a member (the
        frontend's initial roster; idempotent, so two frontends over
        the same lanes converge instead of double-bumping). A member
        registered this way holds NO lease — nothing heartbeats a
        loopback lane, so lease expiry must not walk it down the
        ladder; explicit :meth:`evict`/:meth:`readmit` remain its only
        transitions until a first heartbeat leases it."""
        with self._lock:
            m = self._members.get(host)
            if m is None:
                self._members[host] = _Member(ALIVE, address, None)
                self._bump(host, ALIVE)
            elif address is not None and m.address is None:
                m.address = address

    def heartbeat(self, host: str, address: Optional[str] = None,
                  now: Optional[float] = None) -> dict:
        """Renew ``host``'s lease (creating or resurrecting it — a
        heartbeat from an evicted or unknown host readmits it alive
        with an epoch bump). Returns the renewal ack every agent
        converges on: epoch, coordinator, TTL, the address roster AND
        the full signed view — followers adopt it each beat, so a
        coordinator death is re-elected over real per-host states, not
        a states-less roster (exactly one successor promotes)."""
        _faults.check_site("net.heartbeat")
        if now is None:
            now = self._clock()
        with self._lock:
            m = self._members.get(host)
            if m is None:
                m = self._members[host] = _Member(ALIVE, address, now)
                self._bump(host, ALIVE)
            else:
                if address is not None:
                    m.address = address
                m.renewed = now
                if m.state != ALIVE:
                    m.state = ALIVE
                    self._bump(host, ALIVE)
            _count_hb("ok")
            roster = {h: mm.address for h, mm in self._members.items()
                      if mm.address and mm.state != EVICTED}
            snapshot = self._view_locked()
            ack = {"epoch": self._epoch, "coordinator": self.host,
                   "lease_ttl_ms": int(self.ttl() * 1e3),
                   "roster": roster}
        # sign outside the lock (hashing is the expensive part)
        ack["view"] = snapshot.signed(self._secret).to_wire()
        return ack

    def expire(self, now: Optional[float] = None
               ) -> List[Tuple[str, str, str]]:
        """Walk every lease down the suspected->probed->evicted ladder
        by age past its last renewal; each transition bumps the epoch.
        Returns ``(host, old_state, new_state)`` transitions."""
        if now is None:
            now = self._clock()
        ttl = self.ttl()
        out = []
        with self._lock:
            for host, m in self._members.items():
                if host == self.host or m.state == EVICTED \
                        or m.renewed is None:
                    continue  # self, tombstones and leaseless members
                age = now - m.renewed
                if age > EVICT_AFTER * ttl:
                    target = EVICTED
                elif age > PROBE_AFTER * ttl:
                    target = PROBED
                elif age > SUSPECT_AFTER * ttl:
                    target = SUSPECTED
                else:
                    target = ALIVE
                if _RANK[target] > _RANK[m.state]:
                    out.append((host, m.state, target))
                    m.state = target
                    self._bump(host, target)
        return out

    def evict(self, host: str) -> None:
        """Explicit eviction (the frontend observed the death itself
        — ``kill_host`` / exhausted failover)."""
        with self._lock:
            m = self._members.get(host)
            if m is not None and m.state != EVICTED:
                m.state = EVICTED
                self._bump(host, EVICTED)

    def readmit(self, host: str, address: Optional[str] = None
                ) -> None:
        """Explicit readmission after the resurrection ladder
        re-reconciled the host. A leaseless (statically ensured)
        member stays leaseless — readmission must not start a lease
        nothing will renew."""
        now = self._clock()
        with self._lock:
            m = self._members.get(host)
            if m is None:
                self._members[host] = _Member(ALIVE, address, None)
                self._bump(host, ALIVE)
            elif m.state != ALIVE:
                m.state = ALIVE
                if m.renewed is not None:
                    m.renewed = now
                if address is not None:
                    m.address = address
                self._bump(host, ALIVE)

    def leave(self, host: str) -> None:
        """Remove a drained host entirely (a polite leave is not a
        tombstone)."""
        with self._lock:
            if self._members.pop(host, None) is not None:
                self._bump(host, "left")

    def promote(self, seed: Optional[MembershipView],
                dead: Optional[str] = None) -> None:
        """Become the authority after winning an election: adopt the
        last known view's members (the dead coordinator suspected,
        leases restarted now) and bump past its epoch."""
        now = self._clock()
        with self._lock:
            if seed is not None:
                for host, row in seed.members.items():
                    if host == self.host:
                        continue
                    state = row["state"]
                    if host == dead and state == ALIVE:
                        state = SUSPECTED
                    self._members.setdefault(
                        host, _Member(state, row.get("address"), now))
                self._epoch = max(self._epoch, seed.epoch)
            self._epoch += 1
            _obs.record_event("membership.elect", host=self.host,
                              epoch=self._epoch)
            _gauge_epoch(self.host, self._epoch)

    # lock: holds(_lock)
    def _view_locked(self) -> MembershipView:
        """The unsigned snapshot of the current members + epoch."""
        members = {h: {"state": m.state, "address": m.address}
                   for h, m in self._members.items()}
        return MembershipView(self._epoch, self.host, members)

    def view(self, now: Optional[float] = None) -> MembershipView:
        """The signed current view. Serving implies current ladder
        state, so expiry runs first."""
        _faults.check_site("cluster.view")
        self.expire(now)
        with self._lock:
            snapshot = self._view_locked()
        _count_view("served")
        return snapshot.signed(self._secret)

    def check_epoch(self, epoch: Optional[int],
                    node: Optional[str] = None) -> None:
        """Epoch fencing: reject work stamped with an epoch older than
        the current view (typed transient — refetch and retry)."""
        if epoch is None:
            return
        with self._lock:
            current = self._epoch
        if int(epoch) < current:
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_stale_epoch_total",
                                     node=node or self.host)
            raise StaleEpochError(
                f"operation stamped with stale view epoch {epoch} "
                f"(current {current}) — refetch the view and retry",
                stale=int(epoch), current=current)


def send_heartbeat(address: str, header: dict,
                   timeout: Optional[float] = None) -> dict:
    """One heartbeat/view RPC over its own short-lived socket (the
    membership plane deliberately does not share the request-plane
    connection pool: a wedged data socket must not stop renewals)."""
    from . import frame as _frame
    _faults.check_site("net.heartbeat")
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise InvalidParameterError(
            f"bad membership address {address!r} (want host:port)")
    if timeout is None:
        from ..control.config import global_config
        timeout = global_config().net_connect_timeout_ms / 1e3
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        sock.settimeout(timeout)
        _frame.send_frame(sock, header)
        reply, _ = _frame.recv_frame(sock)
        if reply.get("type") == "error":
            raise _frame.error_from_wire(reply)
        return reply
    finally:
        try:
            sock.close()
        except OSError:
            pass


class MembershipNode:
    """One agent's membership half: roster + cached view + heartbeat
    sender, with an embedded :class:`ViewCoordinator` that activates
    when this host is the elected coordinator (lowest alive id)."""

    def __init__(self, host: str, address: Optional[str] = None,
                 peers: Optional[Dict[str, str]] = None,
                 clock: Callable[[], float] = None,
                 secret=_UNSET):
        self.host = str(host)
        self.address = address
        self._clock = clock or time.monotonic
        self._secret = _secret() if secret is _UNSET else secret
        self._lock = threading.Lock()
        self._roster: Dict[str, str] = dict(peers or {})  #: guarded by _lock
        self._view: Optional[MembershipView] = None  #: guarded by _lock
        #: hosts THIS node locally believes dead (heartbeat failure
        #: streaks) — kept OUTSIDE the adopted view, which is signed
        #: and must never be mutated; cleared on the next successful
        #: renewal. guarded by _lock
        self._suspected: set = set()
        self._fail_streak = 0  #: guarded by _lock
        self._coord = ViewCoordinator(host, clock=self._clock,
                                      secret=self._secret)
        active = not self._roster or self.host <= min(self._roster)
        self._active = active  #: guarded by _lock

    # -- role ----------------------------------------------------------------
    @property
    def is_coordinator(self) -> bool:
        with self._lock:
            return self._active

    def coordinator(self) -> Tuple[str, Optional[str]]:
        """``(host, address)`` of the coordinator this node believes
        in: itself when active, else the election over its freshest
        view (with locally suspected hosts overlaid — the adopted view
        itself stays untouched so its signature keeps verifying), else
        the lowest peer id."""
        with self._lock:
            if self._active:
                return self.host, self.address
            if self._view is not None:
                states = self._view.states()
                for suspect in self._suspected:
                    if suspect in states:
                        states[suspect] = SUSPECTED
                host = elect_coordinator(states)
                if host is not None and host != self.host:
                    row = self._view.members.get(host) or {}
                    addr = row.get("address") \
                        or self._roster.get(host)
                    return host, addr
            host = min(self._roster) if self._roster else self.host
            return host, self._roster.get(host)

    @property
    def epoch(self) -> int:
        with self._lock:
            if not self._active and self._view is not None:
                return self._view.epoch
        return self._coord.epoch

    # -- server side (agent dispatch) ----------------------------------------
    def on_heartbeat(self, host: str, address: Optional[str] = None
                     ) -> dict:
        """Handle an inbound renewal: renew when coordinator, redirect
        otherwise (the sender retargets without waiting a beat)."""
        if self.is_coordinator:
            ack = self._coord.heartbeat(host, address)
            if address:
                with self._lock:
                    self._roster[host] = address
            return ack
        _count_hb("redirect")
        coord, addr = self.coordinator()
        return {"redirect": coord, "address": addr,
                "epoch": self.epoch}

    def on_view(self) -> dict:
        """Serve the signed view: authoritative when coordinator, the
        freshest adopted view otherwise."""
        if self.is_coordinator:
            return self._coord.view().to_wire()
        with self._lock:
            cached = self._view
        if cached is not None:
            _count_view("served")
            return cached.to_wire()
        return self._coord.view().to_wire()

    def check_epoch(self, epoch: Optional[int]) -> None:
        """Epoch fencing at the agent's door."""
        if epoch is None:
            return
        current = self.epoch
        if int(epoch) < current:
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_stale_epoch_total",
                                     node=self.host)
            raise StaleEpochError(
                f"operation stamped with stale view epoch {epoch} "
                f"(current {current}) — refetch the view and retry",
                stale=int(epoch), current=current)

    def adopt(self, wire: dict) -> bool:
        """Verify and adopt a remote view; False when it is older than
        what this node already holds. A signature that does not verify
        is the permanent :class:`NetAuthError`."""
        _faults.check_site("cluster.view")
        view = MembershipView.from_wire(wire)
        if not view.verify(self._secret):
            _count_view("bad_sig")
            raise NetAuthError(
                "membership view signature does not verify")
        with self._lock:
            if self._view is not None \
                    and view.epoch < self._view.epoch:
                _count_view("stale")
                return False
            self._view = view
            for h, row in view.members.items():
                if row.get("address") and row["state"] != EVICTED:
                    self._roster[h] = row["address"]
        _count_view("adopted")
        _gauge_epoch(self.host, view.epoch)
        return True

    # -- sender side (the agent's heartbeat loop) ----------------------------
    def tick(self, send: Callable[[str, dict], dict] = None,
             now: Optional[float] = None) -> str:
        """One heartbeat-loop step. Coordinator: run lease expiry.
        Follower: renew with the coordinator via ``send(address,
        header) -> ack`` (default: the wire RPC), follow redirects,
        adopt the ack; ``COORD_FAIL_STREAK`` consecutive failures
        locally suspects the coordinator, re-elects, and promotes this
        node if it wins."""
        if send is None:
            send = lambda addr, hdr: send_heartbeat(addr, hdr)  # noqa: E731
        if self.is_coordinator:
            self._coord.expire(now)
            return "coordinator"
        coord, addr = self.coordinator()
        header = {"type": "heartbeat", "host": self.host,
                  "address": self.address}
        try:
            if addr is None:
                raise NetProtocolError(
                    f"no address for coordinator {coord!r}")
            ack = send(addr, header)
            if ack.get("redirect") and ack["redirect"] != coord \
                    and ack.get("address"):
                ack = send(ack["address"], header)
            if ack.get("redirect"):
                raise NetProtocolError(
                    f"coordinator redirect loop via {coord!r}")
        except Exception:
            _count_hb("failed")
            return self._on_heartbeat_failure(coord)
        with self._lock:
            self._fail_streak = 0
            self._suspected.clear()  # the coordinator answered
            roster = ack.get("roster") or {}
            for h, a in roster.items():
                if a:
                    self._roster[h] = a
        # adopt the coordinator's signed view riding the ack: THIS is
        # what a later election runs over — without it a coordinator
        # death would leave every follower stateless and self-electing
        view_wire = ack.get("view")
        if view_wire:
            try:
                self.adopt(view_wire)
            except _faults.InjectedFault:
                pass  # the renewal itself succeeded; next beat retries
        _gauge_epoch(self.host, int(ack.get("epoch", 0)))
        return "ok"

    def _on_heartbeat_failure(self, coord: str) -> str:
        with self._lock:
            self._fail_streak += 1
            if self._fail_streak < COORD_FAIL_STREAK:
                return "failed"
            # the coordinator is gone as far as this node can tell:
            # suspect it LOCALLY (never by mutating the adopted view —
            # it is signed and must keep verifying when re-served) and
            # re-run the election over the freshest real states; with
            # no view yet (bootstrap), peers are presumed alive so a
            # high-id node defers instead of self-promoting
            self._fail_streak = 0
            self._suspected.add(coord)
            seed = self._view
            if seed is not None:
                states = dict(seed.states())
            else:
                states = {h: ALIVE for h in self._roster}
            states.setdefault(self.host, ALIVE)
            for suspect in self._suspected:
                states[suspect] = SUSPECTED
            winner = elect_coordinator(states) or self.host
            if winner != self.host:
                # someone else should win; drop the dead coordinator
                # from the roster so the next tick targets the winner
                self._roster.pop(coord, None)
                return "re-elected"
            self._active = True
        self._coord.promote(seed, dead=coord)
        return "promoted"


class HeartbeatLoop:
    """Daemon thread driving :meth:`MembershipNode.tick` every
    ``heartbeat_interval_ms`` (read live — retunes apply on the next
    beat)."""

    def __init__(self, node: MembershipNode,
                 send: Callable[[str, dict], dict] = None):
        self._node = node
        self._send = send
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _interval(self) -> float:
        from ..control.config import global_config
        return global_config().heartbeat_interval_ms / 1e3

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._node.tick(self._send)
            except Exception:
                _count_hb("failed")
            self._stop.wait(self._interval())

    def start(self) -> "HeartbeatLoop":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"spfft-heartbeat-{self._node.host}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
