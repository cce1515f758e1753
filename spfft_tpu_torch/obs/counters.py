"""Labelled counter/gauge registry for the Prometheus export (the port
of ``spfft_tpu/obs/counters.py``).

Metric names follow the Prometheus data model (``spfft_*``, ``_total``
on counters); the exporter
(:func:`spfft_tpu_torch.obs.exporters.prometheus_text`) renders the
registry verbatim, and every part of the process records into the one
:data:`GLOBAL_COUNTERS`. Counters only go up (``inc``); gauges hold the
last written value (``set``). Labels are kwargs.

:data:`METRIC_SPECS` is the JAX package's registry, name for name, type
for type and help for help, without its three ``spfft_hlo_*`` gauges
(they count collectives in XLA's HLO text, which this package has not);
a test holds the two equal.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: The series registry: every ``spfft_*`` counter/gauge any part of the
#: process emits — through :data:`GLOBAL_COUNTERS` or synthesised by
#: ``obs.exporters.prometheus_text``'s serving/registry/timing families
#: — declared exactly once, as ``name: (type, help)``. At runtime
#: :class:`Counters` enforces the declared type and defaults the help
#: text from here.
METRIC_SPECS: Dict[str, Tuple[str, str]] = {
    # compile / plan observability (obs.record_* helpers)
    "spfft_compile_events_total":
        ("counter", "Compile-path events by kind."),
    "spfft_compile_seconds_total":
        ("counter", "Compile-path seconds by kind."),
    "spfft_plan_builds_total":
        ("counter", "Transform plans constructed."),
    "spfft_plan_build_seconds_total":
        ("counter", "Seconds spent constructing plans."),
    "spfft_plan_pallas_fallback_total":
        ("counter",
         "Plan-time Pallas fallback decisions by stage and reason. "
         "Stages: decompress, compress, fused_decompress_zdft, "
         "fused_zdft_compress, dist_fused_decompress_zdft, "
         "dist_fused_zdft_compress."),
    # distributed exchange accounting
    "spfft_exchange_plans_total":
        ("counter", "Distributed plans constructed."),
    "spfft_exchange_wire_bytes":
        ("gauge",
         "Exact off-shard bytes per exchange of the most recent plan."),
    "spfft_exchange_busiest_link_bytes":
        ("gauge",
         "Bottleneck-link bytes per exchange of the most recent plan."),
    "spfft_wire_rung":
        ("gauge",
         "Resolved wire-compression rung of the most recent distributed "
         "plan (0=full, 1=f32, 2=bf16, 3=int8)."),
    "spfft_wire_rung_changes_total":
        ("counter",
         "Controller wire-rung moves by direction (up=escalate under "
         "exposed exchange, down=decay)."),
    "spfft_wire_rung_declined_total":
        ("counter",
         "Wire rungs refused at plan build by reason (over_budget, "
         "exact_count_layout, fault_injected)."),
    # plan-artifact store
    "spfft_store_hits_total":
        ("counter", "Plan-artifact store outcomes: warm loads."),
    "spfft_store_misses_total":
        ("counter", "Plan-artifact store outcomes: misses."),
    "spfft_store_spills_total":
        ("counter", "Plan-artifact store outcomes: write-behind "
                    "spills."),
    "spfft_store_evictions_total":
        ("counter", "Plan-artifact store outcomes: GC evictions."),
    "spfft_store_rejects_total":
        ("counter", "Plan-artifact store outcomes: typed artifact "
                    "rejections by reason."),
    "spfft_store_manifest_refreshes_total":
        ("counter", "Plan-artifact store outcomes: live boot-prewarm "
                    "manifest merges on spill."),
    "spfft_store_aot_skipped_total":
        ("counter", "AOT executables skipped (non-fatal) by reason."),
    # control plane
    "spfft_control_decisions_total":
        ("counter", "Accepted control-plane knob changes."),
    "spfft_control_knob":
        ("gauge", "Current value of each control-plane knob."),
    "spfft_control_clamped_total":
        ("counter", "Knob writes clamped into their declared bounds."),
    "spfft_control_steps_total":
        ("counter", "Feedback-controller evaluation steps."),
    "spfft_control_step_errors_total":
        ("counter", "Feedback-controller steps that raised."),
    # SLO watchdog
    "spfft_slo_evaluations_total":
        ("counter", "SLO watchdog evaluations."),
    "spfft_slo_objective":
        ("gauge", "Declared SLO objective value."),
    "spfft_slo_observed":
        ("gauge", "Observed value at last SLO evaluation."),
    "spfft_slo_burn_rate":
        ("gauge", "observed/objective at last evaluation (-1 = "
                  "infinite: a zero objective was burned)."),
    "spfft_slo_violation":
        ("gauge", "1 while this SLO's burn rate exceeds its budget."),
    "spfft_slo_violations_total":
        ("counter", "SLO violations observed across evaluations."),
    "spfft_slo_window_burn_rate":
        ("gauge", "Mean burn rate over each alerting window "
                  "(labels: slo, window=fast|slow; -1 = infinite)."),
    "spfft_slo_window_alert":
        ("gauge", "1 while BOTH burn windows of this SLO exceed the "
                  "budget (multi-window page condition)."),
    "spfft_slo_window_alerts_total":
        ("counter", "Multi-window page conditions entered."),
    # pod frontend (serve.cluster)
    "spfft_cluster_hosts":
        ("gauge", "Pod frontend host lanes, labelled by lane state."),
    "spfft_cluster_health":
        ("gauge", "Pod aggregate health state (one-hot; worst lane "
                  "health wins)."),
    "spfft_cluster_routed_total":
        ("counter", "Requests routed by the pod frontend, labelled "
                    "{host, kind=single|distributed}."),
    "spfft_cluster_rpcs_total":
        ("counter", "Host-lane RPCs issued by the pod frontend, "
                    "labelled {host, op}."),
    "spfft_cluster_rpc_failures_total":
        ("counter", "Host-lane RPCs that failed, labelled {host, op}."),
    "spfft_cluster_reconciliations_total":
        ("counter", "Pod plan reconciliations, labelled by outcome "
                    "(ok|mismatch|failed)."),
    "spfft_cluster_spmd_requests_total":
        ("counter", "Distributed-plan requests executed on the "
                    "pod-wide SPMD lane."),
    "spfft_cluster_spmd_coalesced_total":
        ("counter", "Distributed requests that shared a coalesced SPMD "
                    "window round (batch >= 2) — one collective round "
                    "moved all of them."),
    "spfft_cluster_spmd_batch_size_total":
        ("counter", "Coalesced SPMD rounds by batch size, labelled "
                    "{size} (the coalescer's batch-size histogram)."),
    "spfft_cluster_lane_deaths_total":
        ("counter", "Host lanes marked dead by the pod frontend, "
                    "labelled by host."),
    # serving families (rendered by exporters._serve_families from a
    # ServeMetrics snapshot)
    "spfft_serve_completed_total":
        ("counter", "Requests completed successfully."),
    "spfft_serve_failed_total":
        ("counter", "Requests resolved with an error."),
    "spfft_serve_rejected_queue_full_total":
        ("counter", "Submits rejected by backpressure."),
    "spfft_serve_expired_deadline_total":
        ("counter", "Requests expired before dispatch."),
    "spfft_serve_fused_batches_total":
        ("counter", "Buckets dispatched through the fused path."),
    "spfft_serve_serial_batches_total":
        ("counter", "Buckets dispatched serially."),
    "spfft_serve_padded_rows_total":
        ("counter", "Ladder pad rows dispatched."),
    "spfft_serve_pinned_batches_total":
        ("counter", "Buckets dispatched at a pinned shape."),
    "spfft_serve_fused_rows_total":
        ("counter", "Live rows dispatched through fused buckets."),
    "spfft_serve_completed_by_class_total":
        ("counter", "Completions per priority class."),
    "spfft_serve_queue_depth":
        ("gauge", "Request queue depth at last enqueue/dequeue."),
    "spfft_serve_max_queue_depth":
        ("gauge", "High-water queue depth."),
    "spfft_serve_latency_seconds":
        ("gauge",
         "Request latency percentiles over the bounded reservoir."),
    "spfft_serve_queue_wait_seconds":
        ("gauge", "Enqueue->dispatch wait percentiles (recent window) "
                  "— the controller's queue-pressure signal."),
    "spfft_serve_device_execute_seconds":
        ("gauge", "Dispatch->materialised bucket time percentiles "
                  "(recent window) — the controller's device-cost "
                  "signal."),
    "spfft_serve_latency_by_class_seconds":
        ("gauge", "Per-priority-class latency percentiles."),
    "spfft_serve_batch_size_total":
        ("counter", "Dispatched buckets by live-row count and path."),
    "spfft_serve_overhead_seconds_total":
        ("counter", "Host-side orchestration seconds."),
    "spfft_serve_health":
        ("gauge", "Executor lifecycle state (one-hot)."),
    # serving failure-handling families (the ServeMetrics.health()
    # numeric counters, rendered as spfft_serve_<key>_total)
    "spfft_serve_retries_total":
        ("counter", "Failure-handling counter: retries."),
    "spfft_serve_retries_exhausted_total":
        ("counter", "Failure-handling counter: retries_exhausted."),
    "spfft_serve_retries_by_class_total":
        ("counter", "Failure-handling counter: retries_by_class."),
    "spfft_serve_retries_exhausted_by_class_total":
        ("counter",
         "Failure-handling counter: retries_exhausted_by_class."),
    "spfft_serve_bucket_fallbacks_total":
        ("counter", "Failure-handling counter: bucket_fallbacks."),
    "spfft_serve_quarantines_total":
        ("counter", "Failure-handling counter: quarantines."),
    "spfft_serve_probations_total":
        ("counter", "Failure-handling counter: probations."),
    "spfft_serve_readmissions_total":
        ("counter", "Failure-handling counter: readmissions."),
    "spfft_serve_no_healthy_device_total":
        ("counter", "Failure-handling counter: no_healthy_device."),
    "spfft_serve_dispatcher_crashes_total":
        ("counter", "Failure-handling counter: dispatcher_crashes."),
    "spfft_serve_dispatcher_restarts_total":
        ("counter", "Failure-handling counter: dispatcher_restarts."),
    "spfft_serve_pin_prewarms_total":
        ("counter", "Failure-handling counter: pin_prewarms."),
    "spfft_serve_purged_expired_total":
        ("counter", "Failure-handling counter: purged_expired."),
    "spfft_serve_request_attributed_failures_total":
        ("counter",
         "Failure-handling counter: request_attributed_failures."),
    # plan-registry families (exporters._registry_families over
    # PlanRegistry.stats())
    "spfft_registry_plans": ("gauge", "Plan registry plans."),
    "spfft_registry_bytes_in_use":
        ("gauge", "Plan registry bytes in use."),
    "spfft_registry_max_bytes": ("gauge", "Plan registry max bytes."),
    "spfft_registry_max_plans": ("gauge", "Plan registry max plans."),
    "spfft_registry_sig_memo_entries":
        ("gauge", "Plan registry sig memo entries."),
    "spfft_registry_sig_memo_bytes":
        ("gauge", "Plan registry sig memo bytes."),
    "spfft_registry_hit_rate": ("gauge", "Plan registry hit rate."),
    "spfft_registry_store_attached":
        ("gauge", "Plan registry store attached."),
    "spfft_registry_hits_total": ("counter", "Plan registry hits."),
    "spfft_registry_misses_total":
        ("counter", "Plan registry misses."),
    "spfft_registry_fast_hits_total":
        ("counter", "Plan registry fast hits."),
    "spfft_registry_evictions_total":
        ("counter", "Plan registry evictions."),
    "spfft_registry_builds_total":
        ("counter", "Plan registry builds."),
    "spfft_registry_build_failures_total":
        ("counter", "Plan registry build failures."),
    "spfft_registry_store_hits_total":
        ("counter", "Plan registry store hits."),
    "spfft_registry_store_misses_total":
        ("counter", "Plan registry store misses."),
    "spfft_registry_store_spills_total":
        ("counter", "Plan registry store spills."),
    # timing + tracer lifecycle families
    "spfft_timing_seconds_total":
        ("counter",
         "Accumulated scope-timer seconds (timing.GlobalTimer)."),
    "spfft_timing_calls_total":
        ("counter", "Scope-timer call counts (timing.GlobalTimer)."),
    "spfft_trace_spans_started_total":
        ("counter", "Spans begun since the tracer's last reset."),
    "spfft_trace_spans_closed_total":
        ("counter", "Spans finished since the tracer's last reset."),
    "spfft_trace_spans_open":
        ("gauge", "Spans currently open (must be 0 at quiescence)."),
    "spfft_trace_events_dropped_total":
        ("counter", "Events dropped by the bounded ring buffer."),
    # flight recorder (obs.recorder): journal, tail retention, bundles
    "spfft_recorder_events_total":
        ("counter",
         "Typed events appended to the flight-recorder journal, "
         "labelled {kind} (every kind declared in EVENT_SPECS)."),
    "spfft_recorder_events_dropped_total":
        ("counter",
         "Journal events dropped (undeclared kind — the analyzer's "
         "event-registry checker catches these statically too)."),
    "spfft_recorder_traces_retained_total":
        ("counter",
         "Completed traces promoted to the retained ring, labelled "
         "{reason=error|slow|flagged}."),
    "spfft_recorder_incidents_total":
        ("counter",
         "Incident bundles captured successfully, labelled {trigger} "
         "(the reason prefix: slo_alert, health_degraded, "
         "health_failed, lane_death, manual, ...)."),
    "spfft_recorder_incident_failures_total":
        ("counter",
         "Incident bundle captures that failed non-fatally (the "
         "obs.capture fault site fires here in chaos storms)."),
    # package-wide fault seam (faults.py) + degradation ladders
    "spfft_faults_injected_total":
        ("counter",
         "Faults fired by a FaultPlan, labelled {site, kind}."),
    "spfft_faults_armed":
        ("gauge", "1 while an ambient fault plan is armed."),
    "spfft_fused_demotions_total":
        ("counter",
         "Runtime fused-kernel demotions to the unfused composition, "
         "labelled by plan direction (which=dec|cmp)."),
    "spfft_fused_reprobes_total":
        ("counter",
         "Fused-path re-probe attempts after a runtime demotion, "
         "labelled {which, outcome=readmitted|failed}."),
    "spfft_store_degraded":
        ("gauge",
         "1 while the plan-artifact store is in memory-only "
         "degradation (persistent disk fault; spills disabled)."),
    "spfft_store_io_retries_total":
        ("counter",
         "Transient store I/O errors absorbed by the bounded "
         "retry-with-backoff rung, labelled by op."),
    "spfft_store_reprobes_total":
        ("counter",
         "Degraded-store disk re-probe attempts, labelled "
         "{outcome=recovered|failed}."),
    "spfft_execute_timeouts_total":
        ("counter",
         "Bucket materialisations that exceeded execute_timeout_ms "
         "and were failed as typed transient ExecuteTimeoutError."),
    # wire transport + elastic membership + remote artifact tier (net/)
    "spfft_cluster_membership_total":
        ("counter",
         "Pod membership transitions, labelled {event="
         "join_started|prewarmed|reconciled|joined|join_failed|"
         "leave_started|drained|left|evicted|readmitted}."),
    "spfft_cluster_spmd_rejected_total":
        ("counter",
         "SPMD-lane submissions refused by admission control, "
         "labelled {reason=queue_full|expired}."),
    "spfft_net_frames_total":
        ("counter", "Wire frames moved, labelled {dir=send|recv}."),
    "spfft_net_bytes_total":
        ("counter",
         "Wire bytes moved (preamble+header+payload), labelled "
         "{dir=send|recv}."),
    "spfft_net_rpc_rtt_seconds":
        ("gauge",
         "EWMA round-trip latency of each host lane's wire RPCs — "
         "the third load_score term, labelled {host}."),
    "spfft_net_agent_requests_total":
        ("counter", "Requests a HostAgent served, labelled {op}."),
    "spfft_net_agent_rejected_total":
        ("counter",
         "Submits a HostAgent refused at its own admission seam, "
         "labelled {reason=queue_full|expired|auth|stale_epoch}."),
    "spfft_blob_ops_total":
        ("counter",
         "Remote blob-tier operations, labelled {op=get|put, "
         "outcome=hit|miss|ok|error}."),
    "spfft_store_remote_total":
        ("counter",
         "Plan-artifact store remote-tier outcomes, labelled "
         "{op=get|put, outcome=hit|miss|ok|error}."),
    # lease-based membership + lane resurrection (round 21)
    "spfft_net_rpc_retries_total":
        ("counter",
         "Wire-RPC connect retries before a lane was declared dead "
         "(bounded backoff in the sync connect path), labelled "
         "{verb}."),
    "spfft_membership_epoch":
        ("gauge",
         "Current membership-view epoch as each node last saw it, "
         "labelled {node} (coordinator host or frontend id) — nodes "
         "converging is the split-brain invariant."),
    "spfft_membership_transitions_total":
        ("counter",
         "Lease-ladder state transitions at the view coordinator, "
         "labelled {host, to=alive|suspected|probed|evicted}."),
    "spfft_membership_heartbeats_total":
        ("counter",
         "Membership lease-renewal heartbeats, labelled "
         "{outcome=ok|redirect|failed}."),
    "spfft_membership_views_total":
        ("counter",
         "Signed membership-view traffic, labelled "
         "{outcome=served|adopted|stale|bad_sig|error}."),
    "spfft_cluster_stale_epoch_total":
        ("counter",
         "Operations rejected for carrying a stale view epoch "
         "(typed transient StaleEpochError; the sender refetches the "
         "view and retries), labelled {node}."),
    "spfft_cluster_probes_total":
        ("counter",
         "Health probes of dead lanes by the resurrection ladder, "
         "labelled {host, outcome=ok|failed}."),
    "spfft_cluster_readmits_total":
        ("counter",
         "Dead-lane readmission attempts after a successful probe, "
         "labelled {host, outcome=readmitted|blocked}."),
    "spfft_blob_gc_total":
        ("counter",
         "Remote blob-tier gc sweep outcomes over the req/ journal "
         "namespace, labelled {outcome=removed|error|skipped}."),
}


class Counters:
    """Thread-safe registry of named counter/gauge families."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"type": "counter"|"gauge", "help": str,
        #          "samples": {(("k","v"), ...): float}}
        self._metrics: Dict[str, dict] = {}  #: guarded by _lock

    # lock: holds(_lock)
    def _family(self, name: str, mtype: str, help_: Optional[str]):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        spec = METRIC_SPECS.get(name)
        if spec is not None:
            # the declared registry is authoritative: a recorder that
            # disagrees with the declared type is the same bug the
            # static counter-registry checker catches, enforced live
            if spec[0] != mtype:
                raise ValueError(
                    f"metric {name!r} is declared a {spec[0]} in "
                    f"METRIC_SPECS but recorded as a {mtype}")
            if help_ is None:
                help_ = spec[1]
        fam = self._metrics.get(name)
        if fam is None:
            fam = self._metrics[name] = {
                "type": mtype, "help": help_ or name, "samples": {}}
        elif fam["type"] != mtype:
            raise ValueError(
                f"metric {name!r} already registered as {fam['type']}")
        return fam

    @staticmethod
    def _key(labels: dict) -> Tuple:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r}")
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def inc(self, name: str, value: float = 1.0,
            help: Optional[str] = None, **labels) -> None:
        """Add ``value`` (>= 0) to counter ``name``."""
        key = self._key(labels)
        with self._lock:
            fam = self._family(name, "counter", help)
            fam["samples"][key] = fam["samples"].get(key, 0.0) \
                + float(value)

    def set(self, name: str, value: float,
            help: Optional[str] = None, **labels) -> None:
        """Set gauge ``name`` to ``value`` (last write wins)."""
        key = self._key(labels)
        with self._lock:
            fam = self._family(name, "gauge", help)
            fam["samples"][key] = float(value)

    def get(self, name: str, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            fam = self._metrics.get(name)
            if fam is None:
                return 0.0
            return fam["samples"].get(key, 0.0)

    def snapshot(self) -> Dict[str, dict]:
        """Deep-enough copy for the exporter: {name: {type, help,
        samples: {labels_tuple: value}}}."""
        with self._lock:
            return {name: {"type": fam["type"], "help": fam["help"],
                           "samples": dict(fam["samples"])}
                    for name, fam in self._metrics.items()}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: Process-global registry (the default sink for every recorder).
GLOBAL_COUNTERS = Counters()
