"""spfft_tpu_torch.obs — observability: tracing, counters, exporters, the
flight recorder (the port of ``spfft_tpu/obs``).

* :mod:`~spfft_tpu_torch.obs.trace` — :class:`Tracer` / :class:`Span` /
  :class:`RequestTrace`; off by default (``SPFFT_TPU_TRACE=1`` or
  :func:`enable`), sampled via ``SPFFT_TPU_TRACE_SAMPLE``, bounded ring
  buffer, zero-unclosed-spans lifecycle contract.
* :mod:`~spfft_tpu_torch.obs.counters` — labelled counter/gauge registry
  (always on; a dict update per record), :data:`METRIC_SPECS` the JAX
  package's but its three ``spfft_hlo_*`` gauges.
* :mod:`~spfft_tpu_torch.obs.exporters` — :func:`export_trace` (Chrome
  trace-event JSON for Perfetto / chrome://tracing),
  :func:`prometheus_text` (text exposition over the counters, the
  ``timing.GlobalTimer`` tree and the tracer) and the validating
  :func:`parse_prometheus_text`.
* :mod:`~spfft_tpu_torch.obs.http` — :class:`MetricsServer`, the opt-in
  stdlib HTTP scrape endpoint (``/metrics``, ``/healthz``, ``/configz``,
  ``/incidentz``) on loopback; ``SPFFT_TPU_METRICS_PORT``.
* :mod:`~spfft_tpu_torch.obs.recorder` — the always-on event journal,
  tail-retained traces and incident bundles (a bundle of either package
  validates in the other).

The helpers below are the seams the plans call: plan builds
(:func:`record_plan_build`), fused-kernel declines
(:func:`record_plan_fallback`), the ``nvcc`` kernel builds
(:func:`record_compile`, kind ``kernel_build``) and the distributed
exchange's byte accounting (:func:`record_exchange_plan`); the store
helpers wait for the serving slice's artifact store. Counters are always
on; spans only when tracing is enabled. Spans time the host: a span
around a CUDA call closes when the launch is queued, as the JAX
package's close at dispatch; nothing here synchronizes the device.

The JAX package's ``record_hlo_counts`` is not ported: it parses XLA's
HLO text, which this package does not have. Its counterpart is the
kernel wrappers' launch counts (``ops._build.count``).
"""

from __future__ import annotations

import time
from typing import Optional

from .counters import GLOBAL_COUNTERS, Counters
from .exporters import (export_trace, parse_prometheus_text,
                        prometheus_text, trace_events)
from .http import METRICS_PORT_ENV, MetricsServer, port_from_env
from .recorder import (BUNDLE_VERSION, EVENT_SPECS, GLOBAL_JOURNAL,
                       build_incident_bundle, capture_incident,
                       disable_recorder, enable_recorder, flag_trace,
                       maybe_auto_capture, merge_pod_bundle,
                       overhead_probe, record_event, recorder_active,
                       recorder_from_env, recorder_stats,
                       reset_recorder, retained_traces,
                       set_health_provider, set_incident_capturer,
                       set_latency_source, validate_bundle,
                       write_bundle)
from .trace import (GLOBAL_TRACER, RequestTrace, Span, TraceContext,
                    Tracer, active, disable, enable, span_context)

__all__ = [
    "Tracer", "Span", "RequestTrace", "GLOBAL_TRACER",
    "TraceContext", "span_context",
    "Counters", "GLOBAL_COUNTERS",
    "active", "enable", "disable",
    "export_trace", "trace_events", "prometheus_text",
    "parse_prometheus_text",
    "MetricsServer", "METRICS_PORT_ENV", "port_from_env",
    "record_compile", "record_plan_build", "record_exchange_plan",
    "record_plan_fallback", "record_store",
    "record_store_aot_skip",
    # flight recorder (obs.recorder)
    "EVENT_SPECS", "GLOBAL_JOURNAL", "BUNDLE_VERSION",
    "record_event", "enable_recorder", "disable_recorder",
    "recorder_active", "recorder_from_env", "recorder_stats",
    "reset_recorder", "flag_trace", "retained_traces",
    "build_incident_bundle", "capture_incident", "write_bundle",
    "maybe_auto_capture", "merge_pod_bundle", "validate_bundle",
    "set_health_provider", "set_incident_capturer",
    "set_latency_source", "overhead_probe",
]


def record_store(event: str, reason: Optional[str] = None) -> None:
    """One plan-artifact-store outcome (``hit`` / ``miss`` / ``spill``
    / ``evict`` / ``reject`` / ``manifest_refresh``; rejects carry
    their typed reason label). Counters always
    (``spfft_store_{hits,misses,spills,evictions,rejects,
    manifest_refreshes}_total``); a ``store`` instant on the compile
    track when tracing is on — next to the ``compile.store_load`` /
    ``compile.store_spill`` spans the store records, so Perfetto shows
    load-vs-build decisions inline with the compile timeline."""
    name = {"hit": "spfft_store_hits_total",
            "miss": "spfft_store_misses_total",
            "spill": "spfft_store_spills_total",
            "evict": "spfft_store_evictions_total",
            "reject": "spfft_store_rejects_total",
            "manifest_refresh":
                "spfft_store_manifest_refreshes_total"}[event]
    labels = {"reason": reason} if event == "reject" else {}
    GLOBAL_COUNTERS.inc(name, 1,
                        help="Plan-artifact store outcomes.", **labels)
    if active():
        args = {"event": event}
        if reason:
            args["reason"] = reason
        GLOBAL_TRACER.instant("store." + event, cat="compile",
                              track="compile", args=args)


def record_store_aot_skip(reason: str) -> None:
    """One non-fatal AOT executable skip (export or deserialize failed,
    platform mismatch) — the artifact/plan is fine, only the
    ahead-of-time executable is absent."""
    GLOBAL_COUNTERS.inc("spfft_store_aot_skipped_total", 1,
                        help="AOT executables skipped (non-fatal) by "
                             "reason.",
                        reason=reason)


def record_plan_fallback(stage: str, reason: str) -> None:
    """One plan-time fused-kernel decline — a fused compression+DFT
    direction routed to the two-kernel path, with why, under the JAX
    package's stage names. Counter always
    (``spfft_plan_pallas_fallback_total`` by {stage, reason}, the JAX
    package's series name), plus an instant annotation on the compile
    track when tracing is on."""
    GLOBAL_COUNTERS.inc("spfft_plan_pallas_fallback_total", 1,
                        help="Plan-time Pallas fallback decisions by "
                             "stage and reason.",
                        stage=stage, reason=reason)
    if active():
        GLOBAL_TRACER.instant("plan.pallas_fallback", cat="compile",
                              track="compile",
                              args={"stage": stage, "reason": reason})


def record_compile(what: str, seconds: float, t0: Optional[float] = None,
                   **info) -> None:
    """One compile event (this package's: ``kernel_build``, one ``nvcc``
    run): counters always, a ``compile`` track span when tracing is
    on. ``t0`` is the ``time.perf_counter()`` start
    when the caller measured a real interval; omitted, the span is
    recorded at now-minus-``seconds``."""
    GLOBAL_COUNTERS.inc("spfft_compile_events_total", 1,
                        help="Compile-path events by kind.", kind=what)
    GLOBAL_COUNTERS.inc("spfft_compile_seconds_total", seconds,
                        help="Compile-path seconds by kind.", kind=what)
    if active():
        t1 = (t0 + seconds) if t0 is not None else time.perf_counter()
        args = {k: v for k, v in info.items()
                if isinstance(v, (str, int, float, bool))}
        GLOBAL_TRACER.complete(f"compile.{what}", t1 - seconds, t1,
                               cat="compile", track="compile",
                               args=args or None)


def record_plan_build(plan, seconds: float,
                      t0: Optional[float] = None) -> None:
    """Called by ``TransformPlan.__init__`` (kind=local) and the
    distributed plan (kind=distributed) with the measured construction
    time (host seconds; table uploads are queued, not waited for)."""
    kind = ("distributed" if hasattr(plan, "dist_plan") else "local")
    GLOBAL_COUNTERS.inc("spfft_plan_builds_total", 1,
                        help="Transform plans constructed.", kind=kind)
    GLOBAL_COUNTERS.inc("spfft_plan_build_seconds_total", seconds,
                        help="Seconds spent constructing plans.",
                        kind=kind)
    if active():
        t1 = (t0 + seconds) if t0 is not None else time.perf_counter()
        try:
            args = {"kind": kind, "precision": plan.precision,
                    "dims": f"{plan.dim_x}x{plan.dim_y}x{plan.dim_z}"}
        except Exception:
            args = {"kind": kind}
        GLOBAL_TRACER.complete("compile.plan_build", t1 - seconds, t1,
                               cat="compile", track="compile", args=args)


def record_exchange_plan(plan, seconds: float,
                         t0: Optional[float] = None) -> None:
    """Surface a ``DistributedTransformPlan``'s exact exchange
    accounting — total/busiest-link wire bytes and, when the overlap
    pipeline is active, the per-chunk split from ``OverlapSchedule`` —
    as counters plus (when tracing) an ``exchange`` track span and a
    per-chunk counter series. Called at plan construction."""
    labels = {"exchange": plan.exchange.value,
              "shards": str(plan.dist_plan.num_shards),
              "chunks": str(plan.overlap_chunks)}
    wire = int(plan.exchange_wire_bytes())
    busiest = int(plan.exchange_busiest_link_bytes())
    GLOBAL_COUNTERS.inc("spfft_exchange_plans_total", 1,
                        help="Distributed plans constructed.", **labels)
    GLOBAL_COUNTERS.set("spfft_exchange_wire_bytes", wire,
                        help="Exact off-shard bytes per exchange of the "
                             "most recent plan.", **labels)
    GLOBAL_COUNTERS.set("spfft_exchange_busiest_link_bytes", busiest,
                        help="Bottleneck-link bytes per exchange of the "
                             "most recent plan.", **labels)
    GLOBAL_COUNTERS.set("spfft_wire_rung",
                        float(getattr(plan, "wire_rung", 0)),
                        help="Resolved wire-compression rung of the most "
                             "recent distributed plan (0=full, 1=f32, "
                             "2=bf16, 3=int8).", **labels)
    if not active():
        return
    ov = getattr(plan, "_overlap", None)
    per_chunk = []
    if ov is not None:
        elem = plan._wire_elem_bytes()
        # int8 rung: each chunk also carries its scale sidecar — one f32
        # per (slot, quant row) over the chunk's stick/plane slice
        int8 = getattr(plan, "wire_rung", 0) == 3
        dp = plan.dist_plan
        links = dp.num_shards * (dp.num_shards - 1)
        for c in range(ov.num_chunks):
            sc_b = (links * ov.chunk_scale_rows(c) * 4) if int8 else 0
            sc_f = (links * ov.chunk_scale_rows(c, forward=True) * 4
                    ) if int8 else 0
            per_chunk.append({
                "bwd_bytes": ov.chunk_wire_elements(c) * elem + sc_b,
                "fwd_bytes": ov.chunk_wire_elements(c, forward=True)
                * elem + sc_f,
                "busiest_link_bytes":
                    ov.chunk_busiest_link_elements(c) * elem,
            })
            GLOBAL_TRACER.counter(
                "exchange.chunk_wire_bytes",
                {"bwd": per_chunk[-1]["bwd_bytes"],
                 "fwd": per_chunk[-1]["fwd_bytes"]},
                cat="exchange", track="exchange")
    t1 = (t0 + seconds) if t0 is not None else time.perf_counter()
    args = dict(labels)
    args.update({"wire_bytes": wire, "busiest_link_bytes": busiest})
    if per_chunk:
        args["per_chunk"] = per_chunk
    GLOBAL_TRACER.complete("exchange.plan_build", t1 - seconds, t1,
                           cat="exchange", track="exchange", args=args)
