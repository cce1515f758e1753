"""Feedback controller: the obs→serve loop, closed (the port of
``spfft_tpu/control/controller.py``: the same rules, thresholds, reason
texts and decision sequence for the same signals).

Consumes the live telemetry the serving stack already produces
(:meth:`ServeMetrics.signals` — queue-wait and device-execute
reservoirs, padded-rows and batch-histogram counters, stage/dispatch
overhead accounting) and retunes the executor's :class:`ServeConfig`
online. Every rule is DETERMINISTIC — pure arithmetic over counter
deltas between steps, no wall-clock reads, no randomness — so a
scripted telemetry sequence always produces the same decision sequence
(the property the tier-1 scenario tests pin).

Signals → rules → knobs (the docs/control_plane.md table, in code):

* **batch_window** ← queue-wait p95 vs device-execute p50. Requests
  waiting much longer than a bucket takes to execute means the window
  is holding a backlog hostage → HALVE the window. Queue drained well
  below the execute time → decay back toward the default (the window
  only ever helps a trickle).
* **pin_after** ← padded-rows ratio. A pad-heavy delta (ladder pad rows
  per fused live row above ``pad_hi``) means the adaptive pinning
  observer is too slow for this trace → pin one bucket sooner. Pads
  gone → decay back toward the default.
* **max_batch** ← fused batch histogram + queue depth. Buckets
  repeatedly full AT the cap while a backlog persists → double the cap
  (more rows per dispatch). Largest fused bucket far below the cap →
  halve back toward the default.
* **pipeline_depth** ← stage-vs-dispatch overlap ratio. Host staging
  cost rivaling dispatch cost means the host is on the critical path →
  one more in-flight slot to overlap it. Staging negligible → decay to
  the auto depth (0): the executor's ``_pipeline_slots()``, one slot
  deeper than the device pool when its plans are on the card.
* **overlap_chunks** ← exchange-vs-compute span ratio. The
  distributed dispatch path records cumulative exchange and
  exchange-compute seconds (``ServeMetrics.record_exchange_overlap``,
  fed from the overlap pipeline's recorded spans); exchange time
  rivaling compute time on ``overlap_streak_steps`` CONSECUTIVE steps
  means the pipeline has compute left to hide the wire behind → DOUBLE
  K (within the declared 1..64 clamp). Exchange well hidden (ratio
  below ``overlap_lo``) → halve back toward the K=1 default, which is
  the bit-identical monolithic path. The streak is the hysteresis —
  one chunky step moves nothing.
* **wire_precision** ← the same exchange-vs-compute deltas, behind
  HARDER thresholds (``wire_hi`` > ``overlap_hi``, longer streak).
  Chunking hides wire time for free; compression spends accuracy
  budget — so the rung escalates one step only when the exchange still
  dominates after the chunking rule has had its chance, and decays one
  step back when the wire is well hidden. Plans built under the new
  value re-probe against their own declared ``wire_error_budget`` and
  may still refuse the rung (the budget gate belongs to the plan, not
  the controller); rung moves are counted
  (``spfft_wire_rung_changes_total{direction}``).
* **max_queue** ← ``rejected_queue_full`` burn. Rejects on
  ``reject_streak_steps`` CONSECUTIVE steps mean the queue bound is
  turning a transient burst into dropped traffic → DOUBLE the bound
  (still clamped to the declared KNOB_SPECS range; memory pressure is
  the hard bound, not the soft one). A single-step blip changes
  nothing — backpressure on a genuine overload is the knob working as
  designed. Idle periods decay the bound back toward the default by
  halving (retracing the growth path).
* **spmd_batch_window / spmd_max_batch** ← SPMD queue depth vs
  collective-launch p50 (``SPMDCoalescer.signals()``, merged in when a
  coalescer is attached). Distributed requests backing up (depth >= 2)
  while the coalescing window is shorter than one collective launch on
  consecutive distributed steps means arrivals during a launch miss
  the next window → DOUBLE the window (more requests per collective
  round); a window above default that coalesces nothing decays back by
  halving. Rounds repeatedly full AT the batch cap with a backlog →
  double ``spmd_max_batch``; rounds far below an elevated cap → halve
  it back (the fused ``max_batch`` rule, re-aimed at the distributed
  lane).

Stability machinery, also deterministic:

* **hysteresis** — every rule's shrink and grow thresholds are far
  apart (``shrink_ratio`` vs ``grow_ratio``, ``pad_hi`` vs ``pad_lo``),
  so a signal sitting between them changes nothing;
* **cooldown** — after a knob moves, that knob is frozen for
  ``cooldown_steps`` controller steps (steps, not seconds: determinism
  again), so one burst cannot see-saw a knob within its own settling
  time;
* **idle decay** — a step with zero completed work and an empty queue
  walks every managed knob one move back toward its declared default.

The controller reads host counters only: its thread never synchronizes
the card or touches a stream, so it can run beside the dispatcher and
the submitters.

Bounds are the config's own clamp — a rule can *request* anything and
the knob still never leaves its declared range (the fuzz invariant).

:class:`ControlLoop` wraps a controller in a background thread for live
serving (``serve.bench --control``); tests call :meth:`Controller.step`
directly with scripted signals.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from .config import ServeConfig


@dataclasses.dataclass(frozen=True)
class Decision:
    """One accepted knob change (the controller's view; the config's
    history carries the same facts for exporters)."""

    step: int
    knob: str
    old: float
    new: float
    reason: str


#: Knobs the feedback rules manage (everything else in ServeConfig is
#: hot-swappable but only moved by operators/the tuner).
MANAGED_KNOBS = ("batch_window", "pin_after", "max_batch",
                 "pipeline_depth", "max_queue", "overlap_chunks",
                 "spmd_batch_window", "spmd_max_batch",
                 "lease_ttl_ms", "wire_precision")


class Controller:
    """Rule-based feedback controller over one executor's config.

    ``metrics`` supplies live signals (:meth:`ServeMetrics.signals`);
    tests may instead pass a ``signals`` dict straight to :meth:`step`.
    ``executor`` is optional and only consulted for the auto pipeline
    depth (the depth rule is skipped without it).
    ``watchdog`` (an :class:`~spfft_tpu_torch.control.slo.SLOWatchdog`) is
    evaluated once per step when given, so one loop drives both
    retuning and SLO accounting.
    """

    def __init__(self, config: ServeConfig, metrics=None, executor=None,
                 watchdog=None, spmd=None, cooldown_steps: int = 3,
                 shrink_ratio: float = 2.0, grow_ratio: float = 0.5,
                 pad_hi: float = 0.25, pad_lo: float = 0.02,
                 exec_floor_s: float = 1e-4,
                 reject_streak_steps: int = 2,
                 overlap_hi: float = 1.0, overlap_lo: float = 0.25,
                 overlap_streak_steps: int = 2,
                 spmd_streak_steps: int = 2,
                 rtt_hi: float = 0.2, rtt_streak_steps: int = 2,
                 wire_hi: float = 1.5, wire_lo: float = 0.25,
                 wire_streak_steps: int = 3):
        self.config = config
        self.metrics = metrics
        self.executor = executor
        self.watchdog = watchdog
        self.spmd = spmd
        self.cooldown_steps = max(0, int(cooldown_steps))
        self.shrink_ratio = float(shrink_ratio)
        self.grow_ratio = float(grow_ratio)
        self.pad_hi = float(pad_hi)
        self.pad_lo = float(pad_lo)
        self.exec_floor_s = float(exec_floor_s)
        self.reject_streak_steps = max(1, int(reject_streak_steps))
        self.overlap_hi = float(overlap_hi)
        self.overlap_lo = float(overlap_lo)
        self.overlap_streak_steps = max(1, int(overlap_streak_steps))
        self.spmd_streak_steps = max(1, int(spmd_streak_steps))
        self.rtt_hi = float(rtt_hi)
        self.rtt_streak_steps = max(1, int(rtt_streak_steps))
        self.wire_hi = float(wire_hi)
        self.wire_lo = float(wire_lo)
        self.wire_streak_steps = max(1, int(wire_streak_steps))
        self._wire_streak = 0
        self._overlap_streak = 0
        self._reject_streak = 0
        self._spmd_streak = 0
        self._rtt_streak = 0
        self._step = 0
        self._prev: Optional[Dict] = None
        self._last_change: Dict[str, int] = {}
        self._decisions: List[Decision] = []

    # -- bookkeeping -------------------------------------------------------
    @property
    def steps(self) -> int:
        return self._step

    def decisions(self) -> List[Decision]:
        return list(self._decisions)

    def _cool(self, knob: str) -> bool:
        last = self._last_change.get(knob)
        return (last is not None
                and self._step - last <= self.cooldown_steps)

    def _retune(self, out: List[Decision], knob: str, value,
                reason: str) -> bool:
        """Apply one rule's request; True when the knob actually moved
        (cooldown respected, clamped no-ops record nothing)."""
        if self._cool(knob):
            return False
        old = self.config.get(knob)
        new = self.config.set(knob, value, reason=reason,
                              source="controller")
        if new != old:
            self._last_change[knob] = self._step
            d = Decision(self._step, knob, old, new, reason)
            self._decisions.append(d)
            out.append(d)
            return True
        return False

    def _delta(self, signals: Dict, key: str) -> float:
        prev = (self._prev or {}).get(key, 0)
        return signals.get(key, 0) - prev

    # -- the rules ---------------------------------------------------------
    def step(self, signals: Optional[Dict] = None) -> List[Decision]:
        """One deterministic control step over ``signals`` (defaults to
        ``self.metrics.signals()``). Returns the decisions accepted this
        step (possibly empty)."""
        if signals is None:
            if self.metrics is None:
                raise ValueError("Controller needs metrics or explicit "
                                 "signals")
            signals = self.metrics.signals()
            if self.spmd is not None:
                signals.update(self.spmd.signals())
        self._step += 1
        out: List[Decision] = []
        first = self._prev is None
        completed_d = self._delta(signals, "completed")
        idle = (completed_d == 0 and signals.get("queue_depth", 0) == 0
                and self._delta(signals, "spmd_launches") == 0
                and signals.get("spmd_queue_depth", 0) == 0)
        if first:
            pass  # calibration step: record the baseline, act next
        elif idle:
            self._reject_streak = 0
            self._overlap_streak = 0
            self._spmd_streak = 0
            self._rtt_streak = 0
            self._wire_streak = 0
            self._decay_toward_defaults(out)
        else:
            self._rule_batch_window(out, signals)
            self._rule_pin_after(out, signals)
            self._rule_max_batch(out, signals)
            self._rule_pipeline_depth(out, signals)
            self._rule_max_queue(out, signals)
            self._rule_overlap_chunks(out, signals)
            self._rule_wire_precision(out, signals)
            self._rule_spmd_coalesce(out, signals)
            self._rule_lease_ttl(out, signals)
        self._prev = dict(signals)
        from .. import obs
        obs.GLOBAL_COUNTERS.inc(
            "spfft_control_steps_total", 1,
            help="Controller steps executed.")
        if self.watchdog is not None:
            self.watchdog.evaluate()
        return out

    def _decay_toward_defaults(self, out: List[Decision]) -> None:
        """Idle: walk each managed knob one move back toward its
        default — windows/halvings retrace their own path, integer knobs
        step by one."""
        for knob in MANAGED_KNOBS:
            cur = self.config.get(knob)
            default = ServeConfig.default(knob)
            if cur == default:
                continue
            if knob in ("batch_window", "spmd_batch_window"):
                # retrace the halving/doubling path, snapping onto the
                # default once one move reaches or crosses it
                if cur < default:
                    nxt = default if cur == 0 or cur * 2 >= default \
                        else cur * 2
                else:
                    nxt = max(default, cur / 2)
            elif knob in ("max_queue", "overlap_chunks",
                          "spmd_max_batch", "lease_ttl_ms"):
                # these grow rules double, so the decay halves — one
                # idle step per growth step back toward the default
                nxt = max(default, cur // 2) if cur > default \
                    else min(default, cur * 2)
            else:
                nxt = cur + 1 if cur < default else cur - 1
            moved = self._retune(out, knob, nxt,
                                 "idle: decay toward default")
            if moved and knob == "wire_precision":
                from .. import obs
                obs.GLOBAL_COUNTERS.inc(
                    "spfft_wire_rung_changes_total", 1,
                    direction="down")

    def _rule_batch_window(self, out, s) -> None:
        qw = s.get("queue_wait_p95", 0.0)
        dx = max(s.get("device_execute_p50", 0.0), self.exec_floor_s)
        w = self.config.get("batch_window")
        default = ServeConfig.default("batch_window")
        if qw > self.shrink_ratio * dx and w > 0.0:
            self._retune(out, "batch_window", w / 2.0,
                         f"queue buildup: queue_wait p95 {qw * 1e3:.2f}"
                         f" ms > {self.shrink_ratio:g} x device p50 "
                         f"{dx * 1e3:.2f} ms")
        elif qw < self.grow_ratio * dx and w < default:
            nxt = default if w == 0.0 else min(default, w * 2.0)
            self._retune(out, "batch_window", nxt,
                         f"queue drained: queue_wait p95 "
                         f"{qw * 1e3:.2f} ms < {self.grow_ratio:g} x "
                         f"device p50 {dx * 1e3:.2f} ms")

    def _rule_pin_after(self, out, s) -> None:
        rows_d = self._delta(s, "fused_rows")
        if rows_d <= 0:
            return
        pad_d = self._delta(s, "padded_rows")
        ratio = pad_d / rows_d
        pin = self.config.get("pin_after")
        default = ServeConfig.default("pin_after")
        if ratio > self.pad_hi and pin > 1:
            self._retune(out, "pin_after", pin - 1,
                         f"pad-heavy trace: {pad_d:g} pad rows / "
                         f"{rows_d:g} live rows = {ratio:.2f}")
        elif ratio < self.pad_lo and pin < default:
            self._retune(out, "pin_after", pin + 1,
                         f"pads gone ({ratio:.3f}): decay toward "
                         f"default")

    def _rule_max_batch(self, out, s) -> None:
        mb = self.config.get("max_batch")
        default = ServeConfig.default("max_batch")
        hist = s.get("fused_hist") or {}
        prev_hist = (self._prev or {}).get("fused_hist") or {}
        full_d = hist.get(mb, 0) - prev_hist.get(mb, 0)
        sizes_d = [b for b in hist
                   if hist.get(b, 0) - prev_hist.get(b, 0) > 0]
        if full_d >= 3 and s.get("max_queue_depth", 0) > mb:
            self._retune(out, "max_batch", mb * 2,
                         f"backlog of full buckets: {full_d:g} buckets "
                         f"at the cap {mb} with queue depth "
                         f"{s.get('max_queue_depth', 0):g}")
        elif mb > default and sizes_d \
                and max(sizes_d) <= max(1, mb // 4):
            self._retune(out, "max_batch", max(default, mb // 2),
                         f"buckets far below cap: largest fused "
                         f"{max(sizes_d)} <= {mb}//4")

    def _rule_max_queue(self, out, s) -> None:
        """Grow the queue bound on SUSTAINED ``rejected_queue_full``
        burn (ROADMAP control follow-on #3): rejects on
        ``reject_streak_steps`` consecutive non-idle steps double
        ``max_queue`` within its declared bounds; the idle decay walks
        it back by halving. One blip is backpressure doing its job and
        moves nothing (the streak is the hysteresis)."""
        rej_d = self._delta(s, "rejected_queue_full")
        if rej_d <= 0:
            self._reject_streak = 0
            return
        self._reject_streak += 1
        if self._reject_streak < self.reject_streak_steps:
            return
        mq = self.config.get("max_queue")
        new = self._retune(
            out, "max_queue", mq * 2,
            f"sustained queue-full burn: +{rej_d:g} rejects on step "
            f"{self._step} ({self._reject_streak} consecutive "
            f"reject steps)")
        if new:
            self._reject_streak = 0

    def _rule_overlap_chunks(self, out, s) -> None:
        """Retune the exchange-overlap chunk count K from recorded
        exchange-vs-compute span seconds (round-18 satellite of the pod
        frontend): exchange time above ``overlap_hi`` x compute time on
        ``overlap_streak_steps`` consecutive distributed steps doubles
        K within the declared clamp — more chunks, more compute to hide
        the wire behind; exchange below ``overlap_lo`` x compute halves
        K back toward the K=1 default (the bit-identical monolithic
        path, which round 9 measured as strictly cheaper when there is
        nothing to hide). Steps with no distributed work reset the
        streak and move nothing."""
        ex_d = self._delta(s, "exchange_s")
        cp_d = self._delta(s, "exchange_compute_s")
        if ex_d <= 0 and cp_d <= 0:
            self._overlap_streak = 0
            return
        k = self.config.get("overlap_chunks")
        default = ServeConfig.default("overlap_chunks")
        ratio = ex_d / max(cp_d, self.exec_floor_s)
        if ratio > self.overlap_hi:
            self._overlap_streak += 1
            if self._overlap_streak >= self.overlap_streak_steps \
                    and self._retune(
                        out, "overlap_chunks", k * 2,
                        f"exchange rivals compute: {ex_d * 1e3:.1f} ms "
                        f"exchange vs {cp_d * 1e3:.1f} ms compute over "
                        f"{self._overlap_streak} consecutive steps"):
                self._overlap_streak = 0
        else:
            self._overlap_streak = 0
            if ratio < self.overlap_lo and k > default:
                self._retune(out, "overlap_chunks",
                             max(default, k // 2),
                             f"exchange hidden ({ratio:.2f} x compute):"
                             f" decay toward default")

    def _rule_wire_precision(self, out, s) -> None:
        """Escalate the wire-compression rung under SUSTAINED exposed
        exchange (the compressed-wire tentpole's controller half): the
        same exchange-vs-compute span deltas that drive
        ``overlap_chunks``, behind harder thresholds (``wire_hi`` >
        ``overlap_hi`` and a longer streak) — chunking hides wire time
        for free, compression spends accuracy budget, so the rung moves
        only when the exchange still dominates after the chunking rule
        has had its chance. One rung per move, within the declared
        [0, 3] clamp; plans built under the new value re-probe against
        their own ``wire_error_budget`` and may still decline (the
        budget gate is the plan's, not the controller's). Exchange well
        hidden (below ``wire_lo``) decays one rung back; streak +
        cooldown are the anti-oscillation guard the scenario test
        pins. Rung moves are counted by direction."""
        ex_d = self._delta(s, "exchange_s")
        cp_d = self._delta(s, "exchange_compute_s")
        if ex_d <= 0 and cp_d <= 0:
            self._wire_streak = 0
            return
        rung = self.config.get("wire_precision")
        default = ServeConfig.default("wire_precision")
        ratio = ex_d / max(cp_d, self.exec_floor_s)
        if ratio > self.wire_hi:
            self._wire_streak += 1
            if self._wire_streak >= self.wire_streak_steps \
                    and self._retune(
                        out, "wire_precision", rung + 1,
                        f"exposed exchange: {ex_d * 1e3:.1f} ms "
                        f"exchange vs {cp_d * 1e3:.1f} ms compute over "
                        f"{self._wire_streak} consecutive steps"):
                self._wire_streak = 0
                from .. import obs
                obs.GLOBAL_COUNTERS.inc(
                    "spfft_wire_rung_changes_total", 1, direction="up")
        else:
            self._wire_streak = 0
            if ratio < self.wire_lo and rung > default:
                if self._retune(
                        out, "wire_precision", rung - 1,
                        f"exchange hidden ({ratio:.2f} x compute): "
                        f"decay toward default"):
                    from .. import obs
                    obs.GLOBAL_COUNTERS.inc(
                        "spfft_wire_rung_changes_total", 1,
                        direction="down")

    def _rule_lease_ttl(self, out, s) -> None:
        """Widen the membership lease under wire-RTT inflation (round
        21): a measured ``wire_rtt`` above ``rtt_hi`` x the lease TTL on
        ``rtt_streak_steps`` consecutive non-idle steps means heartbeat
        renewals are racing the expiry ladder — a slow-but-alive pod
        would start suspecting healthy hosts. Doubling ``lease_ttl_ms``
        within its declared bounds restores the renewal margin; the
        idle decay halves it back once the wire recovers. Steps with no
        RTT signal (loopback pods) reset the streak and move
        nothing."""
        rtt = s.get("wire_rtt", 0.0)
        if rtt <= 0.0:
            self._rtt_streak = 0
            return
        ttl_s = self.config.get("lease_ttl_ms") / 1e3
        if rtt <= self.rtt_hi * ttl_s:
            self._rtt_streak = 0
            return
        self._rtt_streak += 1
        if self._rtt_streak < self.rtt_streak_steps:
            return
        if self._retune(
                out, "lease_ttl_ms",
                self.config.get("lease_ttl_ms") * 2,
                f"wire RTT inflation: {rtt * 1e3:.1f} ms RTT vs "
                f"{ttl_s * 1e3:.0f} ms lease TTL over "
                f"{self._rtt_streak} consecutive steps"):
            self._rtt_streak = 0

    def _rule_spmd_coalesce(self, out, s) -> None:
        """Retune the pod SPMD lane's coalescing window and batch cap
        from the coalescer's live signals (``SPMDCoalescer.signals``):
        distributed requests backing up (queue depth >= 2) while the
        window is shorter than one collective launch on
        ``spmd_streak_steps`` consecutive distributed steps means
        arrivals during a launch keep missing the next window → DOUBLE
        ``spmd_batch_window`` (more requests per collective round); a
        window above default that coalesced nothing this step decays
        back by halving. Rounds repeatedly full AT ``spmd_max_batch``
        with a backlog double the cap; rounds far below an elevated cap
        halve it back — the fused ``max_batch`` rule, re-aimed at the
        distributed lane. Steps with no collective launches reset the
        streak and move nothing."""
        launches_d = self._delta(s, "spmd_launches")
        if launches_d <= 0:
            self._spmd_streak = 0
            return
        depth = s.get("spmd_queue_depth", 0)
        p50 = max(s.get("spmd_launch_p50", 0.0), self.exec_floor_s)
        w = self.config.get("spmd_batch_window")
        default = ServeConfig.default("spmd_batch_window")
        if depth >= 2 and w < p50:
            self._spmd_streak += 1
            if self._spmd_streak >= self.spmd_streak_steps:
                nxt = default if w == 0.0 else w * 2.0
                if self._retune(
                        out, "spmd_batch_window", nxt,
                        f"SPMD backlog: depth {depth:g} with window "
                        f"{w * 1e3:.2f} ms < launch p50 "
                        f"{p50 * 1e3:.2f} ms over {self._spmd_streak} "
                        f"consecutive distributed steps"):
                    self._spmd_streak = 0
        else:
            self._spmd_streak = 0
            if w > default and self._delta(s, "spmd_coalesced") == 0:
                self._retune(out, "spmd_batch_window",
                             max(default, w / 2.0),
                             "window coalesced nothing: decay toward "
                             "default")
        mb = self.config.get("spmd_max_batch")
        mb_default = ServeConfig.default("spmd_max_batch")
        hist = s.get("spmd_batch_hist") or {}
        prev_hist = (self._prev or {}).get("spmd_batch_hist") or {}
        full_d = hist.get(mb, 0) - prev_hist.get(mb, 0)
        sizes_d = [b for b in hist
                   if hist.get(b, 0) - prev_hist.get(b, 0) > 0]
        if full_d >= 2 and depth > 0:
            self._retune(out, "spmd_max_batch", mb * 2,
                         f"full collective rounds: {full_d:g} rounds "
                         f"at the cap {mb} with SPMD queue depth "
                         f"{depth:g}")
        elif mb > mb_default and sizes_d \
                and max(sizes_d) <= max(1, mb // 4):
            self._retune(out, "spmd_max_batch",
                         max(mb_default, mb // 2),
                         f"rounds far below cap: largest coalesced "
                         f"batch {max(sizes_d)} <= {mb}//4")

    def _rule_pipeline_depth(self, out, s) -> None:
        if self.executor is None:
            return
        stage_d = self._delta(s, "stage_s")
        disp_d = self._delta(s, "dispatch_s")
        if disp_d <= 0:
            return
        cur = self.config.get("pipeline_depth")
        try:
            auto = self.executor._pipeline_slots()
        except Exception:
            return
        if stage_d > 0.5 * disp_d:
            base = cur if cur > 0 else auto
            self._retune(out, "pipeline_depth", base + 1,
                         f"host staging on the critical path: stage "
                         f"{stage_d * 1e3:.1f} ms vs dispatch "
                         f"{disp_d * 1e3:.1f} ms")
        elif cur > 0 and stage_d < 0.1 * disp_d:
            nxt = cur - 1 if cur > auto else 0
            self._retune(out, "pipeline_depth", nxt,
                         "staging negligible: decay toward auto depth")


class ControlLoop:
    """Background thread stepping a :class:`Controller` every
    ``interval`` seconds against a live executor. The loop thread is
    the only caller of ``step`` (decisions stay ordered); stop() joins
    it. Use as a context manager around a serving window."""

    def __init__(self, controller: Controller, interval: float = 0.05):
        if interval <= 0:
            raise ValueError("interval must be > 0")
        self.controller = controller
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ControlLoop":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="spfft-control-loop", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.controller.step()
            except Exception:
                # the control plane must never take down the data
                # plane; a broken rule skips a beat, counted below
                from .. import obs
                obs.GLOBAL_COUNTERS.inc(
                    "spfft_control_step_errors_total", 1,
                    help="Controller steps that raised (skipped).")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "ControlLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
