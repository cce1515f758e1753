"""Serving benchmark CLI: ``python -m spfft_tpu_torch.serve.bench`` (the
port of ``spfft_tpu/serve/bench.py``: every flag, mode, check and JSON
key of the JAX CLI).

Replays a mixed-signature request trace through the batching executor
and reports p50/p95/p99 request latency, throughput, batch-size
histogram and registry hit-rate against a serial-loop baseline: the same
trace executed by a caller WITHOUT the serving layer — it hand-builds a
plan per signature at first use (``make_local_plan``: the cold plan cost
the registry amortises) and drives each request synchronously. The warm
re-run of the same loop is also measured and disclosed. The trace is
the JAX bench's: the same seed draws the same signature choices, values
and priorities in the same order of numpy calls, so two runs of the two
packages can be compared request by request. It is drawn once a
replay, before the serial loop, and kept on the host; each request's
values go to the device when it is served (at 256^3 a request is about
0.1 GB, and its draw most of a second of one core).

On the port:

* it runs on the card; ``--cpu`` runs the plans on the host
  (``device="cpu"``, the kernels' plain PyTorch versions). Without a
  card and without ``--cpu`` it exits 1 with the port's
  :class:`~spfft_tpu_torch.errors.DeviceError`;
* ``--devices N`` gives the executor a pool of N slots: ``cuda:i`` for
  slot i by ``i mod device_count`` on the card, ``"cpu"`` on the host
  (the JAX CLI's device pool; 0 = every visible card, or one host slot).
  The fault smoke's quarantine and probation phases need two or more
  slots: on one card they run over two slots of it;
* ``--profile-dir`` writes a ``torch.profiler`` trace of the measured
  replay (``trace.json``);
* where the JAX CLI needs two devices for a distributed plan (the smoke's
  exchange accounting, the ``exchange.plan_build`` span the smoke's trace
  must hold), the port builds its plan of S shards on the one device.

Modes besides the replay:

* ``--smoke`` — a fast, fully DETERMINISTIC trace (no threads, no
  batching windows: fixed-size waves drained synchronously) that
  asserts the adaptive pinning path activates and drives ladder pad
  rows to zero once pinned, with every result checked bit-exact against
  the serial oracle. Exit code 1 on any violated check.
* ``--high-fraction F`` — marks a deterministic F of the trace
  high-priority; the summary and JSON then carry per-class p50/p99.
* ``--fault-rate R`` / ``--fault-script S`` — arm a deterministic
  ``faults.FaultPlan`` for the MEASURED replay (the warm phase runs
  clean), so graceful degradation under injected faults is a recorded
  number (retries, bucket fallbacks, quarantine lifecycle, per-class p99
  shift).
* ``--fault-smoke`` — a fast, fully deterministic failure-semantics
  check: a poisoned request in a fused bucket fails ALONE (co-batched
  requests bit-exact), a transiently-failing bucket recovers everyone,
  an always-failing device slot is quarantined while the pool keeps
  serving (then re-admitted via probation), and a scripted dispatch-loop
  crash resolves EVERY pending future with a typed error — zero hangs.
* ``--chaos SEED`` — the seeded chaos harness: deterministic
  degradation-ladder phases (a fused-launch fault demotes exactly that
  plan direction; an injected ENOSPC flips the artifact store to the
  memory-only tier; a wedged execute trips the ``execute_timeout_ms``
  watchdog; a pod lane death; an SPMD window fault), 16 seeded fault
  STORMS drawn from one RNG, wire and blob storms over a live TCP
  agent, a membership partition storm and the flight recorder under
  fire. Only INJECTED faults may be contained: the wedge is the fault
  seam's host sleep, never a kernel spun on the device, and an error
  that is not the taxonomy's (a CUDA error among them) fails the run.

Observability: ``--trace-out FILE`` enables request tracing for the
measured replay (or the smoke waves) and exports the Chrome trace-event
JSON — in the smoke modes the trace is also VALIDATED (all eight request
stages plus compile and exchange events present, zero unclosed spans);
``--prom-out FILE`` writes the Prometheus text exposition (round-tripped
through the validating parser first).

Control plane: ``--control`` arms the telemetry-driven feedback
controller (:mod:`spfft_tpu_torch.control`) for the measured replay —
live retuning from the metrics stream on its own thread, which reads
host counters only, every decision recorded; in ``--smoke`` it instead
runs the deterministic scripted queue-buildup scenario and asserts a
recorded, bounds-clamped batch-window decision plus zero SLO false
positives. ``--slo`` declares objectives for the SLO watchdog,
``--config`` loads a recommended-config artifact (the ``python -m
spfft_tpu_torch.control tune`` output), and ``--metrics-port`` (or
``SPFFT_TPU_METRICS_PORT``) serves the HTTP ``/metrics`` / ``/healthz``
/ ``/configz`` scrape endpoint for the replay.

The workload is the benchmark CLI's dense-within-cutoff stick generator
(``spfft_tpu_torch.benchmark.cutoff_stick_triplets``) at several
sparsities, so the trace mixes S distinct plan signatures over one grid
size. Prints a human summary plus exactly one JSON line with
``throughput_rps``, ``serial_throughput_rps``, ``speedup_vs_serial`` and
the serving metrics snapshot.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.serve.bench",
        description="spfft_tpu_torch serving-layer benchmark (plan "
                    "registry + concurrent batching executor)")
    p.add_argument("--dim", type=int, default=24,
                   help="cubic grid size per signature (default 24, "
                        "CPU-friendly)")
    p.add_argument("--requests", type=int, default=96,
                   help="trace length (default 96)")
    p.add_argument("--signatures", type=int, default=3,
                   help="distinct plan signatures in the trace "
                        "(default 3); 1 = same-signature trace")
    p.add_argument("--threads", type=int, default=4,
                   help="submitter threads replaying the trace")
    p.add_argument("--window", type=float, default=None,
                   help="batching window seconds (default: the "
                        "executor's DEFAULT_BATCH_WINDOW)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="bucket cap (default: the executor's "
                        "DEFAULT_MAX_BATCH)")
    p.add_argument("--max-queue", type=int, default=1024)
    p.add_argument("--no-batching", action="store_true",
                   help="degrade to serial dispatch (A/B the batcher)")
    p.add_argument("--pin-after", type=int, default=None,
                   help="consecutive same-size buckets before the exact "
                        "shape pins (default: DEFAULT_PIN_AFTER; 0 "
                        "disables pinning)")
    p.add_argument("--high-fraction", type=float, default=0.0,
                   help="fraction of trace requests submitted "
                        "priority='high' (default 0: all normal)")
    p.add_argument("--devices", type=int, default=0,
                   help="size of the executor's device pool: N slots, "
                        "cuda:(i mod the card count) on the card, 'cpu' "
                        "with --cpu (0 = every visible card, or one host "
                        "slot)")
    p.add_argument("--precision", choices=["single", "double"],
                   default="single")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cpu", action="store_true",
                   help="run on the host: device='cpu', the kernels' "
                        "plain PyTorch versions")
    p.add_argument("--smoke", action="store_true",
                   help="fast deterministic pinning check: "
                        "fixed-size waves drained synchronously; "
                        "asserts pinned-path activation, zero pad rows "
                        "once pinned, and bit-exact results")
    p.add_argument("--fault-smoke", action="store_true",
                   help="fast deterministic failure-semantics check "
                        ": bucket isolation, "
                        "retry, quarantine/probation, crash-proof "
                        "dispatch — exit 1 on any violation")
    p.add_argument("--chaos", type=int, default=None, metavar="SEED",
                   help="run the seeded chaos harness: deterministic "
                        "degradation-ladder acceptance phases plus 16 "
                        "seeded multi-seam fault storms; exit 1 on any "
                        "violated invariant")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="per-check probability of an injected transient "
                        "fault during the measured replay (seeded by "
                        "--seed; default 0 = no injection)")
    p.add_argument("--fault-script", default=None,
                   help="comma-separated scripted faults for the "
                        "measured replay, e.g. "
                        "'dispatch@3,device1@*:permanent' "
                        "(see spfft_tpu_torch.faults)")
    p.add_argument("--fault-scope", default=None,
                   help="restrict --fault-rate faults to one site "
                        "(stage|dispatch|materialise) or 'device:N'")
    p.add_argument("--trace-out", default=None, metavar="TRACE.json",
                   help="enable spfft_tpu_torch.obs request tracing and "
                        "write "
                        "the Chrome trace-event JSON here (open in "
                        "Perfetto / chrome://tracing); in the smoke "
                        "modes the trace is also validated (eight "
                        "request stages + compile/exchange events, "
                        "zero unclosed spans) — violations exit 1")
    p.add_argument("--prom-out", default=None, metavar="FILE.prom",
                   help="write obs.prometheus_text() (serving metrics + "
                        "registry + timing + obs counters) here; the "
                        "text is round-tripped through the exposition "
                        "parser first")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the measured "
                        "replay into DIR (trace.json; the card's kernels "
                        "too when the plans run there)")
    p.add_argument("--control", action="store_true",
                   help="enable the telemetry-driven control plane: a "
                        "feedback controller retunes batch window / "
                        "pin policy / bucket cap / pipeline depth from "
                        "live metrics during the measured replay; in "
                        "--smoke it runs a deterministic scripted "
                        "queue-buildup scenario and asserts a recorded "
                        "bounds-clamped knob decision")
    p.add_argument("--control-interval", type=float, default=0.02,
                   help="controller step interval seconds for the live "
                        "replay loop (default 0.02)")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="declare SLOs for the watchdog, e.g. "
                        "'p99_ms=50,error_rate=0.01,max_quarantines=0' "
                        "or '@objectives.json'; burn rates export as "
                        "spfft_slo_* gauges and a violation degrades "
                        "health()")
    p.add_argument("--config", default=None, metavar="CONFIG.json",
                   help="load a recommended-config artifact (the "
                        "'python -m spfft_tpu_torch.control tune' "
                        "output) as "
                        "the executor's boot config; explicit knob "
                        "flags still override it")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve GET /metrics (Prometheus text), "
                        "/healthz and /configz on 127.0.0.1:PORT for "
                        "the replay (0 = ephemeral port; default: the "
                        "SPFFT_TPU_METRICS_PORT env var, else off)")
    p.add_argument("--verify-sample", type=int, default=0, metavar="N",
                   help="after the replay, hold N of its requests "
                        "(spread over the signatures) bit for bit against "
                        "the serial loop's plans on the same values, and "
                        "on the card its kernel launches against its plan "
                        "executions; exit 1 on a mismatch (adds the "
                        "'verify' key; default 0: off)")
    p.add_argument("-o", "--output", default=None, metavar="FILE.json")
    return p.parse_args(argv)


#: Text of an error the CUDA runtime or a CUDA library raised; the chaos
#: harness fails a run in which one is contained as a typed failure.
_CUDA_ERROR_MARKERS = ("CUDA error", "cudaError", "CUBLAS_STATUS",
                       "CUFFT_", "device-side assert",
                       "an illegal memory access")


def _device(args) -> torch.device:
    """The plans' device: the card, or the host with ``--cpu``; raises
    :class:`~spfft_tpu_torch.errors.DeviceError` without a card."""
    from ..plan import resolve_device
    return resolve_device("cpu" if args.cpu else None)


def _pool(args, device: torch.device) -> list:
    """The executor's device pool: ``--devices`` slots (0 = every
    visible card, or one host slot), slot i on ``cuda:(i mod count)``
    on the card and on ``"cpu"`` on the host."""
    if device.type == "cpu":
        return [torch.device("cpu")] * max(args.devices, 1)
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count)
            for i in range(args.devices if args.devices > 0 else count)]


def _host(x) -> np.ndarray:
    """A result as a host array (a tensor on the card is copied back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(a, b) -> bool:
    """Bit-for-bit equality of two results: tensors on one device are
    compared there; anything else on the host (a TCP lane's results
    come back as host tensors)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.device == b.device:
        return a.dtype == b.dtype and torch.equal(a, b)
    return np.array_equal(_host(a), _host(b))


def _make_watchdog(args, metrics):
    """The --slo watchdog (None when undeclared). In the smoke modes a
    default generous healthy-trace spec is used when --control is on
    without --slo, so the no-false-positive property is always
    exercised."""
    from ..control import SLOSpec, SLOWatchdog
    if args.slo:
        return SLOWatchdog(metrics, SLOSpec.parse(args.slo))
    if args.control and (args.smoke or args.fault_smoke):
        return SLOWatchdog(metrics, SLOSpec(latency_p99_s=60.0,
                                            error_rate=0.5,
                                            max_quarantines=64))
    return None


def _launch_counts() -> dict:
    """The launches so far of each kernel wrapper a local C2C plan calls
    (``ops._build.count`` adds one where it launches; 0 on the host,
    where a wrapper runs its plain version)."""
    from ..ops import dft_kernel, fused_kernel, gather_kernel
    return {"decompress_zdft": fused_kernel.decompress_zdft.launches,
            "zdft_compress": fused_kernel.zdft_compress.launches,
            "pdft2": dft_kernel.pdft2.launches,
            "gather": gather_kernel.gather.launches,
            "pdft_last": dft_kernel.pdft_last.launches}


def _verify_replay(args, device, trace, futures, own_plans, metrics,
                   launches) -> dict:
    """``--verify-sample N``: hold N requests of the replay, taken in
    turn from each signature's requests, bit for bit against the serial
    loop's plan on the same values; on the card, hold the replay's
    launches to its plan executions — each batched bucket one launch of
    ``decompress_zdft`` and one of ``pdft2``, each serially served
    request and each pin prewarm run one of each, and no other kernel."""
    failures = []
    by_sig: dict = {}
    for i, (which, _, _) in enumerate(trace):
        by_sig.setdefault(which, []).append(i)
    queues = [list(v) for _, v in sorted(by_sig.items())]
    sample = []
    while len(sample) < args.verify_sample and any(queues):
        for q in queues:
            if q and len(sample) < args.verify_sample:
                sample.append(q.pop(0))
    for i in sample:
        which, vals, _ = trace[i]
        try:
            got = futures[i].result(timeout=120)
        except Exception as exc:
            failures.append(f"request {i} failed: {exc!r}")
            continue
        if not _same(got, own_plans[which].backward(vals)):
            failures.append(f"request {i} (signature {which}) differs "
                            f"from the serial call of its plan")
    sig = metrics.signals()
    snap = metrics.snapshot()
    executions = (snap["fused_batches"]
                  + (sig["completed"] - sig["fused_rows"])
                  + snap["health"]["pin_prewarms"])
    want = dict.fromkeys(launches, 0)
    want["decompress_zdft"] = want["pdft2"] = executions
    if device.type == "cuda":
        if launches != want:
            failures.append(f"launches {launches} != {want} (the "
                            f"replay's plan executions: "
                            f"{snap['fused_batches']} batched buckets, "
                            f"{sig['completed'] - sig['fused_rows']} "
                            f"serial requests, "
                            f"{snap['health']['pin_prewarms']} pin "
                            f"prewarms)")
        launch_check = "checked"
    else:
        launch_check = "not on the card"
    print(f"verify: {len(sample)} requests over {len(by_sig)} signatures "
          f"{'bit for bit' if not failures else 'FAILED'}; launches "
          f"{launches} for {executions} plan executions ({launch_check})")
    for msg in failures:
        print(f"FAIL: verify: {msg}", file=sys.stderr)
    return {"requests": sample, "signatures": len(by_sig),
            "executions": executions, "launches": launches,
            "expected_launches": want, "launch_check": launch_check,
            "failures": failures, "ok": not failures}


def _metrics_port(args):
    from ..obs.http import port_from_env
    return args.metrics_port if args.metrics_port is not None \
        else port_from_env()


def _finish_obs(args, failures, metrics=None, registry=None,
                require_stages=False):
    """Shared --trace-out/--prom-out epilogue: export the trace (and
    structurally validate it in the smoke modes), check for unclosed
    spans, and write/validate the Prometheus text. Appends failure
    strings to ``failures``; returns an obs-summary dict for the JSON
    payload (None when obs was not requested)."""
    if not (args.trace_out or args.prom_out):
        return None
    from .. import obs
    summary = {}
    open_spans = obs.GLOBAL_TRACER.open_count()
    if open_spans:
        failures.append(
            f"{open_spans} unclosed spans after quiescence: "
            f"{obs.GLOBAL_TRACER.open_names()[:10]}")
    summary["open_spans"] = open_spans
    if args.trace_out:
        payload = obs.export_trace(args.trace_out)
        summary["trace_out"] = args.trace_out
        summary["trace_events"] = len(payload["traceEvents"])
        if require_stages:
            from ..obs.__main__ import (REQUEST_STAGES,
                                        validate_trace_payload)
            # the smoke modes build their S-shard plan on the one
            # device, so the exchange's span is always required
            require = REQUEST_STAGES + ("compile.registry_build",
                                        "exchange.plan_build")
            failures.extend(validate_trace_payload(
                payload, require_names=require))
        print(f"wrote {args.trace_out} "
              f"({summary['trace_events']} events)")
    if args.prom_out:
        text = obs.prometheus_text(metrics=metrics, registry=registry)
        try:
            series = obs.parse_prometheus_text(text)
            summary["prom_series"] = len(series)
        except ValueError as exc:
            failures.append(f"prometheus text failed to parse: {exc}")
        with open(args.prom_out, "w") as f:
            f.write(text)
        summary["prom_out"] = args.prom_out
        print(f"wrote {args.prom_out}")
    return summary


def _block(result) -> None:
    """Hard-materialise one result (host readback of one element: on
    the card the copy waits for the result's kernels)."""
    result.reshape(-1)[:1].cpu()


def _run_control_scenario(args, ex, registry, sig, plan, make_vals,
                          wave, failures):
    """The deterministic closed-loop acceptance scenario (``--smoke
    --control``): a SCRIPTED queue buildup — several max_batch-sized
    waves staged before a single synchronous drain, so every request's
    recorded queue wait spans the buckets dispatched ahead of it —
    must make the feedback controller shrink the batching window:
    a recorded, bounds-clamped decision visible in the config history,
    the ``spfft_control_decisions_total`` counter and (when tracing) a
    ``control.retune`` annotation. Every buildup result is checked
    bit-exact against the serial oracle, one more wave is served AFTER
    the retune (mid-stream retune cannot perturb results), and the SLO
    watchdog must report zero violations on this healthy trace (the
    no-false-positive half of the acceptance criterion)."""
    from ..control import Controller, ServeConfig

    watchdog = _make_watchdog(args, ex.metrics)
    controller = Controller(ex.config, metrics=ex.metrics, executor=ex,
                            watchdog=watchdog)
    controller.step()  # baseline: deltas start at the post-wave state
    window_before = ex.config.batch_window
    if window_before <= 0.0:
        failures.append("control scenario needs a nonzero batch "
                        "window to retune")
    buildup = make_vals(6 * ex.config.max_batch)
    oracles = [plan.backward(v) for v in buildup]
    futs = [ex.submit(sig, v) for v in buildup]
    ex._drain_once()
    controller.step()
    for i, (f, expect) in enumerate(zip(futs, oracles)):
        if not _same(f.result(timeout=60), expect):
            failures.append(f"control buildup request {i} diverged "
                            f"from the serial oracle")
    window_after = ex.config.batch_window
    moved = [d for d in controller.decisions()
             if d.knob == "batch_window"]
    if not moved:
        failures.append(
            f"scripted queue buildup produced no batch_window "
            f"decision (window {window_before} -> {window_after}; "
            f"signals: {ex.metrics.signals()})")
    elif window_after >= window_before:
        failures.append(f"batch_window did not shrink under buildup: "
                        f"{window_before} -> {window_after}")
    lo, hi = ServeConfig.bounds("batch_window")
    if not lo <= window_after <= hi:
        failures.append(f"batch_window left its declared bounds: "
                        f"{window_after} not in [{lo}, {hi}]")
    from .. import obs as _obs_mod
    if _obs_mod.GLOBAL_COUNTERS.get(
            "spfft_control_decisions_total", knob="batch_window",
            source="controller") < 1:
        failures.append("spfft_control_decisions_total{knob="
                        "batch_window,source=controller} not recorded")
    # one more wave AFTER the retune: a mid-stream knob change must not
    # perturb results (the correctness contract, observed)
    post = make_vals(wave)
    futs = [ex.submit(sig, v) for v in post]
    ex._drain_once()
    for i, (v, f) in enumerate(zip(post, futs)):
        if not _same(f.result(timeout=60), plan.backward(v)):
            failures.append(f"post-retune request {i} diverged from "
                            f"the serial oracle")
    slo_summary = None
    if watchdog is not None:
        slo_summary = watchdog.evaluate()
        if slo_summary["violations"]:
            failures.append(f"SLO false positive on a healthy trace: "
                            f"{slo_summary['violations']}")
    import dataclasses
    control_summary = {
        "decisions": [dataclasses.asdict(d)
                      for d in controller.decisions()],
        "window_before": window_before,
        "window_after": window_after,
        "bounds": [lo, hi],
        "knobs": ex.config.snapshot(),
        "steps": controller.steps,
    }
    return control_summary, slo_summary


def _run_smoke(args) -> int:
    """Deterministic pinning smoke: one signature, ``WAVES`` waves of
    ``WAVE`` (deliberately NOT a power of two) requests, each wave
    staged then drained synchronously — bucket sizes are exact by
    construction, so the adaptive observer's behaviour is reproducible:
    the first ``pin_after`` waves pad ``WAVE`` up the pow2 ladder, every
    later wave dispatches at the pinned exact shape with zero pad rows.
    Every result is checked bit-exact against the serial oracle."""
    from ..benchmark import cutoff_stick_triplets
    from ..types import TransformType
    from .executor import DEFAULT_PIN_AFTER, ServeExecutor
    from .registry import PlanRegistry

    device = _device(args)
    if args.trace_out or args.prom_out:
        from .. import obs
        obs.enable()
        obs.GLOBAL_TRACER.reset()

    n, WAVE, WAVES = 12, 5, 6
    pin_after = (args.pin_after if args.pin_after is not None
                 else DEFAULT_PIN_AFTER)
    triplets = cutoff_stick_triplets(n, n, n, 0.9, hermitian=False)
    registry = PlanRegistry()
    sig, plan = registry.get_or_build(
        TransformType.C2C, n, n, n, triplets, precision=args.precision,
        device=device)
    nv = plan.index_plan.num_values
    rng = np.random.default_rng(args.seed)
    cfg = None
    if args.config:
        from ..control import ServeConfig
        cfg = ServeConfig.load(args.config)
    # with --control the batching window stays at its (config) default
    # so the scripted buildup has a window for the controller to move;
    # _drain_once never waits windows, so the waves stay deterministic
    ex = ServeExecutor(registry, autostart=False,
                       batch_window=None if args.control else 0.0,
                       pin_after=pin_after, config=cfg)

    def make_vals(count):
        if args.precision == "single":
            return [rng.standard_normal((nv, 2)).astype(np.float32)
                    for _ in range(count)]
        return [rng.standard_normal(nv) + 1j * rng.standard_normal(nv)
                for _ in range(count)]

    failures = []
    pad_rows_per_wave = []
    for w in range(WAVES):
        vals = make_vals(WAVE)
        before = ex.metrics.padded_rows
        futures = [ex.submit(sig, v) for v in vals]
        ex._drain_once()
        pad_rows_per_wave.append(ex.metrics.padded_rows - before)
        for i, (v, f) in enumerate(zip(vals, futures)):
            if not _same(f.result(), plan.backward(v)):
                failures.append(f"wave {w} request {i} diverged from "
                                f"the serial oracle")
    control_summary = slo_summary = None
    if args.control:
        control_summary, slo_summary = _run_control_scenario(
            args, ex, registry, sig, plan, make_vals, WAVE, failures)
    snap = ex.metrics.snapshot(registry)
    ex.close()
    pinned = snap["pinned_batches"]
    if pin_after > 0:
        if pinned < 1:
            failures.append("pinned path never activated")
        if pad_rows_per_wave[-1] != 0:
            failures.append(
                f"stable-size trace still pads after pinning: "
                f"last wave added {pad_rows_per_wave[-1]} pad rows")
    if args.trace_out or args.prom_out:
        # exchange observability rides the smoke: a tiny chunked plan of
        # two shards on the one device records its exact per-chunk wire
        # accounting at construction, then runs one backward
        from ..parallel import make_distributed_plan, make_mesh
        from ..utils.workloads import (even_plane_split,
                                       round_robin_stick_partition)
        parts = round_robin_stick_partition(triplets, (n, n, n), 2)
        planes = even_plane_split(n, 2)
        dplan = make_distributed_plan(
            TransformType.C2C, n, n, n, parts, planes,
            mesh=make_mesh(2, device), precision=args.precision,
            overlap_chunks=2)
        dplan.backward([np.zeros(len(p),
                                 np.complex64 if args.precision == "single"
                                 else np.complex128) for p in parts])
        del dplan
    obs_summary = _finish_obs(args, failures, metrics=ex.metrics,
                              registry=registry, require_stages=True)
    ok = not failures
    print(f"smoke: {WAVES} waves x {WAVE} requests, dim={n}^3, "
          f"pin_after={pin_after}")
    print(f"pad rows per wave: {pad_rows_per_wave} "
          f"(pinned_batches={pinned})")
    if control_summary is not None:
        print(f"control: {len(control_summary['decisions'])} "
              f"decisions, batch_window "
              f"{control_summary['window_before'] * 1e3:.2f} -> "
              f"{control_summary['window_after'] * 1e3:.2f} ms "
              f"(bounds {control_summary['bounds']})")
    if slo_summary is not None:
        print(f"slo: violations={slo_summary['violations'] or 'none'} "
              f"burn={ {k: round(v, 3) for k, v in slo_summary['burn'].items()} }")
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    result = {
        "metric": f"serve.bench --smoke {n}^3 waves={WAVES}x{WAVE} "
                  f"(pinned_batches={pinned}, "
                  f"padded_rows={snap['padded_rows']})",
        "value": 1 if ok else 0,
        "unit": "ok",
        "smoke": True,
        "ok": ok,
        "pinned_batches": pinned,
        "padded_rows_total": snap["padded_rows"],
        "padded_rows_per_wave": pad_rows_per_wave,
        "failures": failures,
        "obs": obs_summary,
        "control": control_summary,
        "slo": slo_summary,
    }
    print(json.dumps(result))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.output}")
    return 0 if ok else 1


def _run_fault_smoke(args) -> int:
    """Deterministic failure-semantics smoke: every acceptance behavior
    of the fault-tolerance layer driven by scripted ``FaultPlan``s over
    synchronously drained waves (phases 1-4) and a live supervised
    dispatcher (phases 5-6) — no probabilistic faults, no timing races
    beyond one quarantine-backoff sleep. Exit code 1 on any violation:

    1. a fused bucket with one POISONED request fails only that request
       (co-batched requests bit-exact vs the serial oracle);
    2. a transiently-failing fused bucket recovers EVERY request via
       per-request serial retry;
    3. a device scripted to always fail is quarantined after
       ``quarantine_after`` consecutive failures and the pool keeps
       serving (every request still succeeds);
    4. a quarantined device whose fault cleared is re-admitted through
       a probation canary and the executor returns to healthy;
    5. a scripted dispatch-loop crash past the restart budget resolves
       every pending future with ``ExecutorCrashedError`` — zero hangs;
    6. the same crash WITHIN the restart budget restarts the loop and
       serves everything (degraded, not failed).

    Phases 3-4 run over the first two slots of the ``--devices`` pool
    (two slots of the one card, or of the host, when it holds one).
    """
    from ..benchmark import cutoff_stick_triplets
    from ..errors import ExecutorCrashedError, ServeError
    from ..types import TransformType
    from .executor import ServeExecutor
    from .faults import FaultPlan
    from .registry import PlanRegistry

    if args.trace_out or args.prom_out:
        from .. import obs
        obs.enable()
        obs.GLOBAL_TRACER.reset()

    device = _device(args)
    n = 12
    triplets = cutoff_stick_triplets(n, n, n, 0.9, hermitian=False)
    registry = PlanRegistry()
    sig, plan = registry.get_or_build(
        TransformType.C2C, n, n, n, triplets, precision=args.precision,
        device=device)
    nv = plan.index_plan.num_values
    rng = np.random.default_rng(args.seed)
    failures = []
    phases = {}

    def vals():
        if args.precision == "single":
            return rng.standard_normal((nv, 2)).astype(np.float32)
        return rng.standard_normal(nv) + 1j * rng.standard_normal(nv)

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    # -- phase 1: poisoned request fails ALONE ------------------------
    ex = ServeExecutor(registry, autostart=False, batch_window=0.0)
    good = [vals() for _ in range(3)]
    oracles = [plan.backward(v) for v in good]
    futs = [ex.submit(sig, v) for v in good[:2]]
    poisoned = ex.submit(sig, np.zeros(3))  # wrong length: poisoned
    futs.append(ex.submit(sig, good[2]))
    ex._drain_once()
    for f, expect in zip(futs, oracles):
        check(_same(f.result(timeout=30), expect),
              "phase1: healthy co-batched request diverged from oracle")
    try:
        poisoned.result(timeout=30)
        check(False, "phase1: poisoned request did not fail")
    except Exception:
        pass
    check(ex.metrics.health()["bucket_fallbacks"] >= 1,
          "phase1: fused bucket never fell back to serial recovery")
    ex.close()
    phases["1_poisoned_isolated"] = ex.metrics.health()

    # -- phase 2: transient bucket fault recovers everyone ------------
    ex = ServeExecutor(registry, autostart=False, batch_window=0.0,
                       fault_plan=FaultPlan(script="dispatch@1"))
    good = [vals() for _ in range(4)]
    oracles = [plan.backward(v) for v in good]
    futs = [ex.submit(sig, v) for v in good]
    ex._drain_once()
    for f, expect in zip(futs, oracles):
        check(_same(f.result(timeout=30), expect),
              "phase2: request not recovered bit-exact after transient "
              "bucket fault")
    h = ex.metrics.health()
    check(h["retries"] == 4 and h["retries_exhausted"] == 0,
          f"phase2: expected 4 clean retries, got {h}")
    ex.close()
    phases["2_transient_recovered"] = h

    # -- phases 3-4: quarantine + probation (need a 2+ slot pool) -----
    pool = _pool(args, device)
    if len(pool) >= 2:
        ex = ServeExecutor(registry, autostart=False, devices=pool[:2],
                           quarantine_after=2, quarantine_backoff=30.0,
                           fault_plan=FaultPlan(script="device0@*"))
        for i in range(8):
            v = vals()
            expect = plan.backward(v)
            f = ex.submit(sig, v)
            ex._drain_once()
            check(_same(f.result(timeout=30), expect),
                  f"phase3: request {i} failed under a sick device")
        h = ex.health()
        check(h["quarantines"] == 1,
              f"phase3: sick device not quarantined exactly once: {h}")
        check(h["devices"][0]["state"] == "quarantined",
              "phase3: device 0 not in quarantined state")
        check(h["state"] == "degraded",
              f"phase3: health should be degraded, got {h['state']}")
        ex.close()
        phases["3_quarantine"] = h

        ex = ServeExecutor(registry, autostart=False, devices=pool[:2],
                           quarantine_after=1, quarantine_backoff=0.05,
                           fault_plan=FaultPlan(script="device0@1"))
        v = vals()
        expect = plan.backward(v)
        f = ex.submit(sig, v)
        ex._drain_once()
        check(_same(f.result(timeout=30), expect),
              "phase4: request not recovered around one-shot device "
              "fault")
        time.sleep(0.06)  # past the quarantine backoff: probation due
        v = vals()
        expect = plan.backward(v)
        f = ex.submit(sig, v)
        ex._drain_once()
        check(_same(f.result(timeout=30), expect),
              "phase4: probation canary request failed")
        h = ex.health()
        check(h["probations"] == 1 and h["readmissions"] == 1,
              f"phase4: probation/readmission not observed: {h}")
        check(h["devices"][0]["state"] == "healthy"
              and h["state"] == "healthy",
              f"phase4: device not re-admitted to healthy: {h}")
        ex.close()
        phases["4_readmission"] = h
    else:
        phases["3_quarantine"] = phases["4_readmission"] = \
            f"skipped: a pool of {len(pool)} slot (--devices 2 runs them)"

    # -- phase 5: loop crash past the budget fails every future -------
    ex = ServeExecutor(registry, autostart=False,
                       max_dispatch_restarts=0,
                       fault_plan=FaultPlan(script="loop@1:permanent"))
    futs = [ex.submit(sig, vals()) for _ in range(5)]
    ex.start()
    for i, f in enumerate(futs):
        try:
            f.result(timeout=30)
            check(False, f"phase5: future {i} resolved with a result "
                         f"after a dispatch-loop crash")
        except ExecutorCrashedError:
            pass
        except Exception as exc:
            check(False, f"phase5: future {i} failed with {type(exc)}, "
                         f"not ExecutorCrashedError")
    h = ex.metrics.health()
    check(h["state"] == "failed" and h["dispatcher_crashes"] == 1,
          f"phase5: supervisor state wrong after give-up: {h}")
    try:
        ex.submit(sig, vals())
        check(False, "phase5: submit accepted work on a failed executor")
    except ServeError:
        pass
    ex.close()
    phases["5_crash_fails_futures"] = h

    # -- phase 6: loop crash within the budget restarts and serves ----
    ex = ServeExecutor(registry, autostart=False,
                       max_dispatch_restarts=2,
                       fault_plan=FaultPlan(script="loop@1"))
    good = [vals() for _ in range(5)]
    oracles = [plan.backward(v) for v in good]
    futs = [ex.submit(sig, v) for v in good]
    ex.start()
    for f, expect in zip(futs, oracles):
        check(_same(f.result(timeout=30), expect),
              "phase6: request lost across a supervised restart")
    h = ex.metrics.health()
    check(h["dispatcher_restarts"] == 1 and h["state"] == "degraded",
          f"phase6: restart not recorded as degraded: {h}")
    ex.close()
    phases["6_crash_restart_recovers"] = h

    # the acceptance observable: EVERY span opened across all six
    # failure phases (poisoned buckets, injected faults, quarantines,
    # supervised crashes) closed — with error status on the failure
    # paths — before the executors quiesced
    obs_summary = _finish_obs(args, failures, metrics=ex.metrics,
                              registry=registry)
    ok = not failures
    print(f"fault smoke: dim={n}^3 precision={args.precision} "
          f"devices={len(pool)}")
    for name, h in phases.items():
        print(f"  {name}: {h}")
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    result = {
        "metric": f"serve.bench --fault-smoke {n}^3 (6 phases: "
                  f"isolation/retry/quarantine/probation/crash/restart)",
        "value": 1 if ok else 0,
        "unit": "ok",
        "fault_smoke": True,
        "ok": ok,
        "failures": failures,
        "phases": {k: v for k, v in phases.items()},
        "obs": obs_summary,
    }
    print(json.dumps(result, default=str))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2, default=str)
        print(f"wrote {args.output}")
    return 0 if ok else 1


def _run_chaos(args) -> int:
    """Seeded chaos harness (``--chaos SEED``):
    the package-wide fault seam exercised end to end. Four
    deterministic acceptance phases prove each degradation ladder —

    A. a fused-kernel launch fault at execution time stickily demotes
       EXACTLY that plan direction to the unfused composition
       (recorded reason), the demoted retry is bit-exact, and the next
       request succeeds;
    B. an injected ENOSPC mid-spill flips the artifact store to the
       memory-only tier (``health()`` degraded, spills skipped,
       rejects counted) while serving continues, leaving no
       half-written artifact behind;
    C. a wedged bucket execute trips the ``execute_timeout_ms``
       watchdog into a typed transient failure and every request is
       recovered through the serial fallback;
    D. killing one host lane of a 2-host pod mid-trace degrades the
       pod, the killed lane's queue resolves typed (never hangs), and
       every post-kill request lands bit-exact on the survivor;
    D2. an armed ``cluster.spmd_window`` fault fails EVERY member of a
       coalesced SPMD round typed, and the next round (the one-shot
       script spent) is bit-exact —

    then 16 fault STORMS, every choice drawn from ONE seeded RNG: each
    storm arms a scripted multi-site :class:`~spfft_tpu_torch.faults`
    ambient plan over a menu spanning four subsystems (executor
    stage/dispatch/materialise/loop, plan build, registry build, store
    load/spill/fsync/replace), drives a fresh registry + store +
    executor through a request wave, and asserts the invariants: every
    future resolves (zero hangs), every failure is a TYPED taxonomy
    error, healthy requests are bit-exact vs a clean serial oracle,
    zero unclosed obs spans after quiescence, and the store holds no
    torn ``.tmp-`` files and verifies clean. Phase G then arms the
    flight recorder over a live 2-host pod and proves the black box
    under fire: a lane death auto-captures a validating POD bundle
    holding the fault-site journal events and the typed failure's
    tail-retained trace, and an armed ``obs.capture`` fault fails the
    capture path contained (zero torn bundles) before healing. Only
    injected faults may be contained: phase C's wedge is the seam's host
    sleep, never a kernel spun on the card (a hung kernel cannot be
    cancelled), each phase ends by synchronizing the card, and a CUDA
    error, raised there or hidden behind a typed failure, fails the
    run. Exit code 1 on any violation."""
    import concurrent.futures as cf
    import os
    import shutil
    import tempfile

    from .. import faults, obs
    from ..benchmark import cutoff_stick_triplets
    from ..errors import GenericError
    from ..types import TransformType
    from .executor import ServeExecutor
    from .faults import FaultPlan
    from .registry import PlanRegistry
    from .store import PlanArtifactStore

    device = _device(args)
    #: every store restores its plans on the run's device
    on_device = {"device": device}
    obs.enable()
    obs.GLOBAL_TRACER.reset()
    faults.disarm()
    seed = int(args.chaos)
    rng = np.random.default_rng(seed)
    failures: list = []
    phases = {}
    #: the typed-failure contract: every rejected/failed request raises
    #: a taxonomy error (GenericError covers Serve/TableBuild/Injected)
    #: or a request-shaped builtin (poisoned payloads)
    typed = (GenericError,) + faults.REQUEST_ERROR_TYPES
    fired_sites: dict = {}

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    def tally(plan_f):
        for s, c in plan_f.stats()["fired_by_site"].items():
            fired_sites[s] = fired_sites.get(s, 0) + c

    def spans_closed(where):
        n = obs.GLOBAL_TRACER.open_count()
        check(n == 0, f"{where}: {n} unclosed obs spans: "
                      f"{obs.GLOBAL_TRACER.open_names()[:10]}")
        # the card itself must have come through: only injected faults
        # are contained, so a sticky CUDA error fails the phase here
        if device.type == "cuda":
            try:
                torch.cuda.synchronize(device)
            except Exception as exc:  # noqa: BLE001 - reported below
                check(False, f"{where}: the card raised {exc!r}")

    def not_cuda(exc):
        """A typed failure is a contained one only when no CUDA error
        hides behind it (its message or any cause in its chain)."""
        seen = set()
        while exc is not None and id(exc) not in seen:
            seen.add(id(exc))
            text = f"{type(exc).__name__}: {exc}"
            if any(m in text for m in _CUDA_ERROR_MARKERS):
                check(False, f"a CUDA error was contained as a typed "
                             f"failure: {text[:300]}")
                return
            exc = exc.__cause__ or exc.__context__ \
                or getattr(exc, "cause", None)

    def torn_files(root):
        return [f for _, _, fs in os.walk(root) for f in fs
                if f.startswith(".tmp-")]

    # -- phase A: fused-launch fault demotes exactly that direction ----
    # the plan takes the fused route on its device (the card's fused z
    # kernels; their plain versions on the host); the armed
    # ``kernel.launch`` check fires at the backward's fused dispatch
    from ..plan import make_local_plan
    trip = np.asarray([(x, y, z) for x in range(8) for y in range(6)
                       if (x + y) % 3 != 0 for z in range(0, 128, 2)],
                      np.int32)
    try:
        fp = make_local_plan(TransformType.C2C, 8, 6, 128, trip,
                             precision="single", device=device,
                             fused=True)
        nvf = fp.index_plan.num_values
        v = (rng.standard_normal(nvf)
             + 1j * rng.standard_normal(nvf)).astype(np.complex64)
        oracle = fp.backward(v)  # fused, disarmed
        check(not fp.fused_demotions(),
              "phaseA: plan started demoted on the fused route")
        kplan = FaultPlan(script="kernel.launch@1")
        faults.arm(kplan)
        out = fp.backward(v)  # demote + unfused retry
        faults.disarm()
        check(_same(out, oracle),
              "phaseA: demoted retry diverged from the fused result")
        dem = fp.fused_demotions()
        check(set(dem) == {"dec"},
              f"phaseA: expected exactly the backward direction "
              f"demoted, got {sorted(dem)}")
        check("runtime" in dem.get("dec", {}).get("reason", ""),
              f"phaseA: demotion reason not recorded: {dem}")
        out2 = fp.backward(v)  # next request: unfused path
        check(_same(out2, oracle),
              "phaseA: request after demotion failed or diverged")
        tally(kplan)
        phases["A_fused_demotion"] = dem
    finally:
        faults.disarm()
    spans_closed("phaseA")

    # -- shared workload: one signature, one clean oracle plan ---------
    n = 10
    trip = cutoff_stick_triplets(n, n, n, 0.8, hermitian=False)
    oracle_reg = PlanRegistry(store=False)
    osig, oplan = oracle_reg.get_or_build(
        TransformType.C2C, n, n, n, trip, precision=args.precision,
        device=device)
    nv = oplan.index_plan.num_values

    def vals():
        if args.precision == "single":
            return rng.standard_normal((nv, 2)).astype(np.float32)
        return rng.standard_normal(nv) + 1j * rng.standard_normal(nv)

    # -- phase B: ENOSPC mid-spill -> memory-only tier, serving on -----
    tmp = tempfile.mkdtemp(prefix="spfft-chaos-store-")
    try:
        store = PlanArtifactStore(tmp, plan_kwargs=on_device)
        splan = FaultPlan(script="store.spill@1:enospc")
        faults.arm(splan)
        try:
            store.save_plan(osig, oplan, trip)
            check(False, "phaseB: injected ENOSPC did not surface")
        except OSError as exc:
            check(faults.is_persistent_disk_error(exc),
                  f"phaseB: ENOSPC surfaced untyped: {exc!r}")
        faults.disarm()
        check(store.degraded and store.health()["state"] == "degraded",
              f"phaseB: store not degraded after ENOSPC: "
              f"{store.health()}")
        # serving continues: spills are SKIPPED (counted), requests run
        key = store.save_plan(osig, oplan, trip)
        check(store.stats()["rejects"].get("degraded", 0) >= 1,
              f"phaseB: degraded spill not counted: {store.stats()}")
        check(not os.path.exists(store.artifact_path(key)),
              "phaseB: memory-only tier still wrote an artifact")
        with ServeExecutor(PlanRegistry(store=store), autostart=False,
                           batch_window=0.0) as ex:
            ex.registry.get_or_build(TransformType.C2C, n, n, n, trip,
                                     precision=args.precision,
                                     device=device)
            w = vals()
            f = ex.submit(osig, w)
            ex._drain_once()
            check(_same(f.result(timeout=60), oplan.backward(w)),
                  "phaseB: request failed while the store is degraded")
        store.drain()
        check(not torn_files(tmp),
              "phaseB: torn .tmp- artifact left behind")
        tally(splan)
        phases["B_enospc_memory_only"] = store.health()
    finally:
        faults.disarm()
        shutil.rmtree(tmp, ignore_errors=True)
    spans_closed("phaseB")

    # -- phase C: execute watchdog turns a wedged execute transient ----
    wplan = FaultPlan(script="materialise@1:hang", hang_seconds=5.0)
    ex = ServeExecutor(PlanRegistry(store=False), autostart=False,
                       batch_window=0.0, fault_plan=wplan)
    ex.registry.get_or_build(TransformType.C2C, n, n, n, trip,
                             precision=args.precision, device=device)
    ex.config.set("execute_timeout_ms", 200, source="init",
                  reason="chaos watchdog phase")
    t0_wd = obs.GLOBAL_COUNTERS.get("spfft_execute_timeouts_total")
    good = [vals() for _ in range(3)]
    oracles = [oplan.backward(w) for w in good]
    t_wedge = time.perf_counter()
    futs = [ex.submit(osig, w) for w in good]
    ex._drain_once()
    for i, (f, expect) in enumerate(zip(futs, oracles)):
        check(_same(f.result(timeout=60), expect),
              f"phaseC: request {i} not recovered around the wedged "
              f"execute")
    elapsed = time.perf_counter() - t_wedge
    check(elapsed < 5.0,
          f"phaseC: recovery waited out the full hang "
          f"({elapsed:.1f} s) — watchdog never tripped")
    wd = obs.GLOBAL_COUNTERS.get("spfft_execute_timeouts_total") - t0_wd
    check(wd >= 1, "phaseC: spfft_execute_timeouts_total not bumped")
    h = ex.metrics.health()
    ex.close()
    check(h["bucket_fallbacks"] >= 1,
          f"phaseC: wedged bucket never fell back serial: {h}")
    tally(wplan)
    phases["C_execute_watchdog"] = {"timeouts": wd,
                                    "recovered_in_s": round(elapsed, 2)}
    spans_closed("phaseC")

    # -- phase D: pod lane death mid-trace -> degraded, survivors on --
    from .cluster import PodFrontend
    lanes = []
    for host in ("h0", "h1"):
        reg = PlanRegistry(store=False)
        reg.put(osig, oplan)
        lanes.append((host, ServeExecutor(reg)))
    pod = PodFrontend(lanes, seed=seed)
    try:
        good = [vals() for _ in range(8)]
        oracles = [oplan.backward(w) for w in good]
        futs = [pod.submit_backward(osig, w) for w in good[:4]]
        pod.kill_host("h1")  # half the trace already in flight
        futs += [pod.submit_backward(osig, w) for w in good[4:]]
        served = failed = 0
        for i, (f, expect) in enumerate(zip(futs, oracles)):
            try:
                got = f.result(timeout=60)
            except cf.TimeoutError:
                check(False, f"phaseD: pod request {i} HUNG across "
                             f"the lane death")
            except typed as exc_t:
                not_cuda(exc_t)
                failed += 1  # killed lane's queue resolves typed
            except Exception as exc:
                check(False, f"phaseD: pod request {i} failed UNTYPED "
                             f"{type(exc).__name__}: {exc}")
            else:
                served += 1
                check(_same(got, expect),
                      f"phaseD: pod request {i} diverged from the "
                      f"serial oracle after the lane death")
        check(served >= 4,
              f"phaseD: survivor host served only {served}/8 — the "
              f"post-kill wave must all land on the live lane")
        h = pod.health()
        check(h["state"] == "degraded" and h["alive"] == 1,
              f"phaseD: pod health wrong after lane death: {h}")
        phases["D_pod_lane_death"] = {"served": served,
                                      "typed_failures": failed,
                                      "health": h["state"]}
    finally:
        pod.close()
        for _, ex_l in lanes:
            ex_l.close()
    spans_closed("phaseD")

    # -- phase D2: SPMD window fault fails the whole round typed ------
    # chaos-smoke runs on a 1-device mesh, so the storm aims a
    # duck-typed plan at the coalescer's window seam: one armed
    # ``cluster.spmd_window`` fault must fail EVERY coalesced member
    # typed, and the next round (fault spent) must be bit-exact.
    from ..control.config import global_config
    from ..types import Scaling
    from .cluster import SPMDCoalescer

    class _CoalescePlan:
        def coalesce_backward(self, values_list):
            return [np.asarray(v) * 2.0 for v in values_list]

    spmd_fp = FaultPlan(script="cluster.spmd_window@1")
    faults.arm(spmd_fp)
    spmd = SPMDCoalescer(max_workers=1)
    cfg_d2 = global_config()
    old_window = cfg_d2.spmd_batch_window
    cfg_d2.set("spmd_batch_window", 0.3, source="chaos",
               reason="phase D2 coalescing window")
    try:
        doomed = [spmd.submit(osig, _CoalescePlan(), vals(),
                              "backward", Scaling.NONE, None)
                  for _ in range(2)]
        spmd_failed = 0
        for i, f in enumerate(doomed):
            try:
                f.result(timeout=60)
                check(False, f"phaseD2: coalesced member {i} served "
                             f"through an armed window fault")
            except typed as exc_t:
                not_cuda(exc_t)
                spmd_failed += 1
            except Exception as exc:
                check(False, f"phaseD2: member {i} failed UNTYPED "
                             f"{type(exc).__name__}: {exc}")
        good_v = [vals() for _ in range(2)]
        healed = [spmd.submit(osig, _CoalescePlan(), v, "backward",
                              Scaling.NONE, None) for v in good_v]
        for i, (f, v) in enumerate(zip(healed, good_v)):
            check(np.array_equal(_host(f.result(timeout=60)),
                                 np.asarray(v) * 2.0),
                  f"phaseD2: post-fault round member {i} diverged")
        sig_d2 = spmd.signals()
        check(sig_d2["spmd_coalesced"] >= 2,
              f"phaseD2: the window never coalesced: {sig_d2}")
    finally:
        faults.disarm()
        cfg_d2.set("spmd_batch_window", old_window, source="chaos",
                   reason="restore after phase D2")
        spmd.close()
    tally(spmd_fp)
    phases["D2_spmd_window_fault"] = {
        "typed_failures": spmd_failed,
        "coalesced": sig_d2["spmd_coalesced"],
        "launches": sig_d2["spmd_launches"]}
    spans_closed("phaseD2")

    # -- seeded storms -------------------------------------------------
    #: site menu: (site, subsystem, flow order, script kinds). Extras
    #: are only drawn from LATER flow stages than the primary, so the
    #: primary always fires even when it aborts the storm's flow.
    #: ``exchange.quantize`` leads the flow (the wire-ladder probe runs
    #: before everything else in a distributed plan build) and takes
    #: the dedicated dist-plan storm flow below instead of the
    #: registry/executor one.
    menu = (
        ("exchange.quantize", "exchange", 0, ("transient",)),
        ("store.load", "store", 1, ("transient", "enospc")),
        ("registry.build", "registry", 2, ("transient", "permanent")),
        ("plan.build", "plan", 3, ("transient", "permanent")),
        ("store.spill", "store", 4, ("transient", "enospc")),
        ("store.fsync", "store", 5, ("transient", "enospc")),
        ("store.replace", "store", 6, ("transient", "enospc")),
        ("stage", "executor", 7, ("transient", "permanent", "poison")),
        ("dispatch", "executor", 8, ("transient", "permanent")),
        ("materialise", "executor", 9, ("transient", "hang")),
        ("loop", "executor", 10, ("transient", "permanent")),
    )
    subsystem_of = {site: sub for site, sub, _, _ in menu}
    subsystem_of["cluster.spmd_window"] = "cluster"  # phase D2
    # shared fixture for the exchange.quantize storms: a 1-shard
    # distributed plan (chaos-smoke runs on one CPU device) whose wire
    # probe still exercises the int8 scale computation, plus a clean
    # full-rung oracle — at S=1 no collective runs, so the degraded
    # plan must stay BIT-exact, not merely within budget.
    from ..parallel.dist import DistributedTransformPlan, \
        build_distributed_plan
    wire_trip = cutoff_stick_triplets(8, 8, 8, 0.9, hermitian=False)
    wire_dp = build_distributed_plan(TransformType.C2C, 8, 8, 8,
                                     [wire_trip], [8])
    wire_oplan = DistributedTransformPlan(wire_dp, precision="single",
                                          device=device)
    nv_w = wire_dp.shard_plans[0].num_values
    wire_vals = [(rng.standard_normal(nv_w)
                  + 1j * rng.standard_normal(nv_w)).astype(np.complex64)]
    wire_oracle = wire_oplan.backward(wire_vals)
    storms = 16
    wave = 5
    storm_log = []
    for storm in range(storms):
        site, _, order, kinds = menu[storm % len(menu)]
        kind = kinds[int(rng.integers(len(kinds)))]
        # stage/dispatch are checked once per fused bucket and the wave
        # fits one bucket, so nth=2 would never fire there — only the
        # per-request/per-iteration sites (materialise, loop) can take
        # a deeper traversal
        nth = int(rng.integers(1, 3)) if order >= 9 else 1
        script = [f"{site}@{nth}:{kind}"]
        later = [m for m in menu if m[2] > order]
        if later and rng.random() < 0.5:
            extra = later[int(rng.integers(len(later)))]
            script.append(f"{extra[0]}@1:{extra[3][0]}")
        plan_f = FaultPlan(script=script, hang_seconds=0.2)
        if site == "exchange.quantize":
            # wire-ladder storm: the armed fault fires during the int8
            # probe's scale computation -> typed transient, the plan
            # falls back EXACTLY one rung (int8 -> bf16), records the
            # decline, and still serves bit-exact (S=1: no collective).
            obs.GLOBAL_TRACER.reset()
            outcome = {"script": script, "served": 0,
                       "typed_failures": 0, "wire_rung": None}
            try:
                faults.arm(plan_f)
                try:
                    wplan = DistributedTransformPlan(
                        wire_dp, precision="single",
                        wire_precision=3, wire_error_budget=1.0,
                        device=device)
                except typed as exc_t:
                    not_cuda(exc_t)
                    outcome["typed_failures"] += 1
                    check(False, f"storm {storm} {script}: quantize "
                                 f"fault ESCAPED the probe's decline "
                                 f"ladder")
                except Exception as exc:
                    check(False, f"storm {storm} {script}: UNTYPED "
                                 f"build failure "
                                 f"{type(exc).__name__}: {exc}")
                else:
                    outcome["wire_rung"] = wplan.wire_rung_name
                    check(wplan.wire_rung == 2,
                          f"storm {storm} {script}: faulted probe did "
                          f"not fall back one rung "
                          f"({wplan.wire_rung_name})")
                    check(("int8", "fault_injected")
                          in wplan.wire_declines,
                          f"storm {storm} {script}: decline reason not "
                          f"recorded: {wplan.wire_declines}")
                    got = wplan.backward(wire_vals)
                    check(_same(got, wire_oracle),
                          f"storm {storm} {script}: degraded-rung plan "
                          f"diverged from the oracle")
                    outcome["served"] += 1
                faults.disarm()
                spans_closed(f"storm {storm} {script}")
                tally(plan_f)
            finally:
                faults.disarm()
            storm_log.append(outcome)
            continue
        good = [vals() for _ in range(wave)]
        oracles = [oplan.backward(w) for w in good]
        obs.GLOBAL_TRACER.reset()
        tmp = tempfile.mkdtemp(prefix="spfft-chaos-")
        outcome = {"script": script, "served": 0, "typed_failures": 0}
        try:
            faults.arm(plan_f)
            registry = PlanRegistry(
                store=PlanArtifactStore(tmp, plan_kwargs=on_device))
            try:
                sig, _ = registry.get_or_build(
                    TransformType.C2C, n, n, n, trip,
                    precision=args.precision, device=device)
            except typed as exc_t:
                not_cuda(exc_t)
                outcome["typed_failures"] += 1
                outcome["build"] = "typed failure"
            except Exception as exc:
                check(False, f"storm {storm} {script}: UNTYPED build "
                             f"failure {type(exc).__name__}: {exc}")
            else:
                ex = ServeExecutor(registry, autostart=False,
                                   batch_window=0.0,
                                   max_dispatch_restarts=2,
                                   fault_plan=plan_f)
                futs = [ex.submit(sig, w) for w in good]
                ex.start()
                for i, (f, expect) in enumerate(zip(futs, oracles)):
                    try:
                        got = f.result(timeout=120)
                    except cf.TimeoutError:
                        check(False, f"storm {storm} {script}: request "
                                     f"{i} HUNG")
                    except typed as exc_t:
                        not_cuda(exc_t)
                        outcome["typed_failures"] += 1
                    except Exception as exc:
                        check(False,
                              f"storm {storm} {script}: request {i} "
                              f"failed UNTYPED "
                              f"{type(exc).__name__}: {exc}")
                    else:
                        outcome["served"] += 1
                        check(_same(got, expect),
                              f"storm {storm} {script}: request {i} "
                              f"diverged from the serial oracle")
                ex.close()
            if registry._disk is not None:
                registry._disk.drain()
            faults.disarm()
            check(not torn_files(tmp),
                  f"storm {storm} {script}: torn .tmp- artifact left")
            bad = [row for row in PlanArtifactStore(
                tmp, plan_kwargs=on_device).verify()
                   if not row.get("ok")]
            check(not bad,
                  f"storm {storm} {script}: store verify failed: {bad}")
            spans_closed(f"storm {storm} {script}")
            tally(plan_f)
        finally:
            faults.disarm()
            shutil.rmtree(tmp, ignore_errors=True)
        storm_log.append(outcome)

    # -- phase E: wire + blob storms over a live TCP agent -------------
    # The same seeded-storm discipline pointed at the pod's wire. One
    # in-process HostAgent serves every storm over real localhost
    # sockets; client and agent threads share the ambient plan, so the
    # ``net.*`` sites fire on BOTH ends — dropped/truncated frames,
    # refused accepts, mid-RPC socket death. Each storm also boots a
    # cold artifact store off a faulted remote blob tier. Invariants:
    # every wire failure is TYPED (``HostLaneError`` or a taxonomy
    # error off the error frame), zero hangs, a clean post-disarm
    # request is bit-exact, zero open spans — and blob faults stay
    # CONTAINED (the remote tier is best-effort: they become
    # ``spfft_store_remote_total{outcome="error"}`` counts, never a
    # request failure).
    from ..net.agent import HostAgent
    from ..net.blobstore import FileBlobStore
    from ..net.transport import TcpHostLane

    net_menu = (
        ("net.frame", "net", ("transient",)),
        ("net.send", "net", ("transient",)),
        ("net.recv", "net", ("transient", "hang")),
        ("net.accept", "net", ("transient",)),
        ("cluster.rpc", "cluster", ("transient",)),
        ("blob.get", "blob", ("transient",)),
        ("blob.put", "blob", ("transient",)),
    )
    subsystem_of.update({site: sub for site, sub, _ in net_menu})
    agent_reg = PlanRegistry(store=False)
    agent_reg.put(osig, oplan)
    agent_ex = ServeExecutor(agent_reg)
    agent = HostAgent("chaos-h0", agent_ex).start()
    blob_tmp = tempfile.mkdtemp(prefix="spfft-chaos-blob-")
    wire_storms = len(net_menu) + 1
    try:
        blob = FileBlobStore(blob_tmp)
        # seed the blob tier once, clean, so storm-time gets find a
        # real artifact behind the faulted fetch path
        seed_tmp = tempfile.mkdtemp(prefix="spfft-chaos-seed-")
        try:
            seed_store = PlanArtifactStore(seed_tmp, remote=blob,
                                           plan_kwargs=on_device)
            seed_store.save_plan(osig, oplan, trip)
            seed_store.drain()
        finally:
            shutil.rmtree(seed_tmp, ignore_errors=True)
        for storm in range(wire_storms):
            site, _, kinds = net_menu[storm % len(net_menu)]
            kind = kinds[int(rng.integers(len(kinds)))]
            nth = 1 if site.startswith("blob") \
                else int(rng.integers(1, 4))
            script = [f"{site}@{nth}:{kind}"]
            if rng.random() < 0.5:
                extra = net_menu[int(rng.integers(len(net_menu)))]
                if extra[0] != site:
                    script.append(f"{extra[0]}@1:{extra[2][0]}")
            plan_f = FaultPlan(script=script, hang_seconds=0.2)
            good = [vals() for _ in range(4)]
            oracles = [oplan.backward(w) for w in good]
            obs.GLOBAL_TRACER.reset()
            outcome = {"script": script, "served": 0,
                       "typed_failures": 0, "wire": True}
            lane = TcpHostLane("chaos-h0", ("127.0.0.1", agent.port))
            boot_tmp = tempfile.mkdtemp(prefix="spfft-chaos-boot-")
            try:
                faults.arm(plan_f)
                futs = []
                for w in good:
                    try:
                        futs.append(lane.rpc_submit(osig, w,
                                                    ctx=None))
                    except typed as exc_t:
                        not_cuda(exc_t)
                        outcome["typed_failures"] += 1
                        futs.append(None)
                    except Exception as exc:
                        check(False,
                              f"wire storm {storm} {script}: submit "
                              f"failed UNTYPED "
                              f"{type(exc).__name__}: {exc}")
                        futs.append(None)
                for i, (f, expect) in enumerate(zip(futs, oracles)):
                    if f is None:
                        continue
                    try:
                        got = f.result(timeout=60)
                    except cf.TimeoutError:
                        check(False, f"wire storm {storm} {script}: "
                                     f"request {i} HUNG")
                    except typed as exc_t:
                        not_cuda(exc_t)
                        outcome["typed_failures"] += 1
                    except Exception as exc:
                        check(False,
                              f"wire storm {storm} {script}: request "
                              f"{i} failed UNTYPED "
                              f"{type(exc).__name__}: {exc}")
                    else:
                        outcome["served"] += 1
                        check(_same(got, expect),
                              f"wire storm {storm} {script}: request "
                              f"{i} diverged from the serial oracle")
                # cold boot off the faulted blob tier: contained, typed
                try:
                    boot_reg = PlanRegistry(
                        store=PlanArtifactStore(boot_tmp, remote=blob,
                                            plan_kwargs=on_device))
                    outcome["boot_warmed"] = \
                        boot_reg.prewarm_signatures([osig],
                                                    strict=False)
                    boot_reg.store.save_plan(osig, oplan, trip)
                    boot_reg.store.drain()
                except Exception as exc:
                    check(False,
                          f"wire storm {storm} {script}: blob-tier "
                          f"fault ESCAPED the best-effort seam as "
                          f"{type(exc).__name__}: {exc}")
                faults.disarm()
                # the wire heals: a clean request through the same
                # lane lands bit-exact
                w = vals()
                got = lane.rpc_submit(osig, w, ctx=None).result(
                    timeout=60)
                check(_same(got, oplan.backward(w)),
                      f"wire storm {storm} {script}: post-disarm "
                      f"request not bit-exact")
                spans_closed(f"wire storm {storm} {script}")
                tally(plan_f)
            finally:
                faults.disarm()
                lane.close()
                shutil.rmtree(boot_tmp, ignore_errors=True)
            storm_log.append(outcome)
    finally:
        faults.disarm()
        agent.close()
        agent_ex.close(drain=False)
        shutil.rmtree(blob_tmp, ignore_errors=True)
    phases["E_wire_blob_storms"] = {
        "storms": wire_storms,
        "served": sum(o["served"] for o in storm_log
                      if o.get("wire")),
        "typed_failures": sum(o["typed_failures"] for o in storm_log
                              if o.get("wire")),
    }
    spans_closed("phaseE")

    # -- phase F: partition storm — self-healing membership ------------
    # The round-21 liveness ladder under deterministic partitions.
    # F1: TWO frontends over the SAME loopback pod share one
    # ViewCoordinator — a lane death observed by frontend A evicts the
    # lane with an epoch bump, frontend B's stale stamp is fenced typed
    # (StaleEpochError, counted) and recovers by refetching, both
    # converge on the SAME epoch/view, survivors stay bit-exact, and
    # the resurrection ladder (probe -> blocked-under-fault ->
    # re-reconcile -> readmit) brings the lane back warm. F2: a
    # three-node lease-based membership on a fake clock — the
    # coordinator dies, its heartbeat targets re-elect the SAME
    # successor deterministically, an expired lease walks
    # suspected->probed->evicted, and a restarted node's next heartbeat
    # readmits it alive. The three round-21 sites (net.heartbeat,
    # cluster.view, cluster.readmit) each fire typed and contained.
    from ..errors import StaleEpochError
    from ..net.membership import (ALIVE, EVICTED, MembershipNode,
                                  ViewCoordinator)
    from .cluster import HostLane, PodFrontend

    subsystem_of.update({"net.heartbeat": "membership",
                         "cluster.view": "membership",
                         "cluster.readmit": "cluster"})

    # F1 — two-frontend convergence over a shared coordinator
    reg_f0 = PlanRegistry(store=False)
    reg_f0.put(osig, oplan)
    reg_f1 = PlanRegistry(store=False)
    reg_f1.put(osig, oplan)
    ex_f0 = ServeExecutor(reg_f0)
    ex_f1 = ServeExecutor(reg_f1)
    mm = ViewCoordinator("h0")
    fa = PodFrontend([HostLane("h0", ex_f0), HostLane("h1", ex_f1)],
                     membership=mm, seed=seed)
    fb = PodFrontend([HostLane("h0", ex_f0), HostLane("h1", ex_f1)],
                     membership=mm, seed=seed + 1)
    try:
        for front, tag in ((fa, "fa"), (fb, "fb")):
            w = vals()
            got = front.submit(osig, w).result(timeout=60)
            check(_same(got, oplan.backward(w)),
                  f"phaseF1: pre-storm request via {tag} diverged")
        epoch0 = fa.epoch
        check(fb.epoch == epoch0,
              f"phaseF1: frontends disagree pre-storm "
              f"({fa.epoch} vs {fb.epoch})")
        # frontend A observes h1's death: failover + eviction + bump.
        # _mark_dead is the detection event a failed RPC delivers
        # (kill_host would also close the executor we resurrect below).
        dead_lane = fa._lanes[1]
        fa._mark_dead(dead_lane)
        for _ in range(3):
            w = vals()
            got = fa.submit(osig, w).result(timeout=60)
            check(_same(got, oplan.backward(w)),
                  "phaseF1: survivor request diverged after kill")
        check(fa.epoch > epoch0,
              f"phaseF1: eviction did not bump the epoch "
              f"({epoch0} -> {fa.epoch})")
        # frontend B is now STALE: its next submit is fenced typed
        # (counted) and recovers by refetching the shared view
        stale0 = obs.GLOBAL_COUNTERS.get(
            "spfft_cluster_stale_epoch_total", node="frontend")
        w = vals()
        got = fb.submit(osig, w).result(timeout=60)
        check(_same(got, oplan.backward(w)),
              "phaseF1: stale frontend's request diverged")
        check(obs.GLOBAL_COUNTERS.get(
                  "spfft_cluster_stale_epoch_total",
                  node="frontend") > stale0,
              "phaseF1: stale frontend was not fenced typed")
        check(fb.epoch == fa.epoch,
              f"phaseF1: frontends did not converge after eviction "
              f"({fa.epoch} vs {fb.epoch})")
        va, vb = fa.view(), fb.view()
        check(va["epoch"] == vb["epoch"]
              and va["members"] == vb["members"],
              f"phaseF1: views diverge: {va} vs {vb}")
        check(va["members"]["h1"]["state"] == EVICTED,
              f"phaseF1: h1 not tombstoned evicted: {va}")
        # resurrection: readmission BLOCKED under an armed
        # cluster.readmit fault, then clean probe readmits warm
        dead_lane.transport.alive = True
        fplan = FaultPlan(script=["cluster.readmit@1"])
        faults.arm(fplan)
        out1 = fa.probe_dead(force=True)
        faults.disarm()
        tally(fplan)
        check(out1.get("h1") == "blocked",
              f"phaseF1: faulted readmit not blocked: {out1}")
        out2 = fa.probe_dead(force=True)
        check(out2.get("h1") == "readmitted",
              f"phaseF1: clean probe did not readmit: {out2}")
        check(fa.view()["members"]["h1"]["state"] == ALIVE,
              "phaseF1: readmitted lane not alive in the view")
        check(fb.view()["epoch"] == fa.epoch,
              "phaseF1: frontends did not converge after readmission")
        for front, tag in ((fa, "fa"), (fb, "fb")):
            w = vals()
            got = front.submit(osig, w).result(timeout=60)
            check(_same(got, oplan.backward(w)),
                  f"phaseF1: post-readmit request via {tag} diverged")
        phases["F1_two_frontend_convergence"] = {
            "epoch": fa.epoch, "members": fa.view()["members"]}
    finally:
        faults.disarm()
        fa.close()
        fb.close()
    spans_closed("phaseF1")

    # F2 — lease expiry, deterministic re-election, heartbeat readmit
    now_s = [0.0]
    nodes: dict = {}
    down: set = set()

    def mem_wire(addr, hdr):
        if addr in down:
            raise OSError(f"{addr} unreachable (partitioned)")
        return nodes[addr].on_heartbeat(str(hdr["host"]),
                                        hdr.get("address"))

    for h in ("m0", "m1", "m2"):
        peers = {p: p for p in ("m0", "m1", "m2") if p != h}
        nodes[h] = MembershipNode(h, address=h, peers=peers,
                                  clock=lambda: now_s[0], secret=None)
    check(nodes["m0"].is_coordinator
          and not nodes["m1"].is_coordinator,
          "phaseF2: lowest host id is not the initial coordinator")
    for h in ("m1", "m2"):
        check(nodes[h].tick(mem_wire) == "ok",
              f"phaseF2: initial heartbeat from {h} failed")
    # net.heartbeat fires typed and is CONTAINED in the tick
    fplan = FaultPlan(script=["net.heartbeat@1"])
    faults.arm(fplan)
    check(nodes["m1"].tick(mem_wire) == "failed",
          "phaseF2: faulted heartbeat not contained as 'failed'")
    faults.disarm()
    tally(fplan)
    check(nodes["m1"].tick(mem_wire) == "ok",
          "phaseF2: heartbeat did not recover post-disarm")
    # cluster.view fires typed on view serving
    fplan = FaultPlan(script=["cluster.view@1"])
    faults.arm(fplan)
    try:
        nodes["m0"].on_view()
        check(False, "phaseF2: armed cluster.view did not fire")
    except typed as exc_t:
        not_cuda(exc_t)
        pass
    faults.disarm()
    tally(fplan)
    for h in ("m1", "m2"):
        check(nodes[h].adopt(nodes["m0"].on_view()),
              f"phaseF2: {h} did not adopt the coordinator view")
    # kill the coordinator: its heartbeat targets re-elect the SAME
    # successor (lowest alive id) after COORD_FAIL_STREAK failures
    down.add("m0")
    outcomes = [nodes["m1"].tick(mem_wire) for _ in range(3)]
    check(outcomes[-1] == "promoted",
          f"phaseF2: m1 did not promote itself: {outcomes}")
    check(nodes["m1"].is_coordinator,
          "phaseF2: promoted node is not coordinator")
    m2_out = [nodes["m2"].tick(mem_wire) for _ in range(4)]
    check("re-elected" in m2_out and m2_out[-1] == "ok",
          f"phaseF2: m2 did not re-elect and re-target m1: {m2_out}")
    check(nodes["m2"].adopt(nodes["m1"].on_view()),
          "phaseF2: m2 did not adopt the new coordinator's view")
    check(nodes["m2"].epoch == nodes["m1"].epoch,
          f"phaseF2: epochs diverge after election "
          f"({nodes['m1'].epoch} vs {nodes['m2'].epoch})")
    # lease expiry ladder: m2 stops renewing, the clock runs past
    # EVICT_AFTER x TTL, the coordinator evicts it with a bump
    pre_evict = nodes["m1"].epoch
    now_s[0] += 10.0
    nodes["m1"].tick(mem_wire)  # coordinator tick runs expiry
    states = {h: r["state"]
              for h, r in nodes["m1"].on_view()["members"].items()}
    check(states.get("m2") == EVICTED,
          f"phaseF2: silent m2 not evicted by lease expiry: {states}")
    check(nodes["m1"].epoch > pre_evict,
          "phaseF2: lease eviction did not bump the epoch")
    # epoch fencing at the agent door: the pre-eviction stamp is
    # rejected typed, the current stamp passes
    try:
        nodes["m1"].check_epoch(pre_evict - 1)
        check(False, "phaseF2: stale epoch stamp not fenced")
    except StaleEpochError:
        pass
    nodes["m1"].check_epoch(nodes["m1"].epoch)
    # restart: the evicted node's next heartbeat readmits it alive
    check(nodes["m2"].tick(mem_wire) == "ok",
          "phaseF2: restarted node's heartbeat failed")
    states = {h: r["state"]
              for h, r in nodes["m1"].on_view()["members"].items()}
    check(states.get("m2") == ALIVE,
          f"phaseF2: restarted m2 not readmitted alive: {states}")
    phases["F2_lease_election"] = {
        "coordinator": nodes["m1"].coordinator()[0],
        "epoch": nodes["m1"].epoch, "states": states}
    spans_closed("phaseF2")

    # -- phase G: flight recorder — auto-captured incident bundles -----
    # The black box under fire. G1: the recorder armed over a live
    # 2-host loopback pod — a transient executor fault journals its
    # firing, a poisoned request's errored trace is tail-retained, and
    # a lane death auto-captures a POD bundle that must hold all of it
    # (validating schema, fault-site events, the typed failure's
    # trace). G2: an armed ``obs.capture`` fault fails the capture
    # path CONTAINED (None return, counted, zero torn ``.tmp``) and
    # the next capture heals with both outcomes journalled.
    subsystem_of["obs.capture"] = "obs"
    inc_tmp = tempfile.mkdtemp(prefix="spfft-chaos-incident-")
    obs.reset_recorder()
    obs.enable_recorder(incident_dir=inc_tmp, min_interval_s=0.0)
    g_plans = [FaultPlan(script="dispatch@1") for _ in range(2)]
    lanes_g = []
    for host, plan_g in zip(("g0", "g1"), g_plans):
        reg = PlanRegistry(store=False)
        reg.put(osig, oplan)
        lanes_g.append((host, ServeExecutor(reg, fault_plan=plan_g)))
    podg = PodFrontend(lanes_g, seed=seed)
    try:
        # transient dispatch faults fire (journalled), requests recover
        good = [vals() for _ in range(3)]
        for i, w in enumerate(good):
            got = podg.submit_backward(osig, w).result(timeout=60)
            check(_same(got, oplan.backward(w)),
                  f"phaseG: request {i} not recovered bit-exact "
                  f"through the armed dispatch fault")
        # a poisoned request fails TYPED and its trace is retained
        try:
            podg.submit_backward(osig, np.zeros(3)).result(timeout=60)
            check(False, "phaseG: poisoned request did not fail")
        except typed as exc_t:
            not_cuda(exc_t)
            pass
        except Exception as exc:
            check(False, f"phaseG: poisoned request failed UNTYPED "
                         f"{type(exc).__name__}: {exc}")
        err_traces = [t for t in obs.retained_traces()
                      if t["reason"] == "error"]
        check(err_traces,
              "phaseG: typed failure's trace was not tail-retained")
        kinds_now = {e["kind"] for e in obs.GLOBAL_JOURNAL.snapshot()}
        check("fault.fired" in kinds_now,
              f"phaseG: armed fault firing not journalled "
              f"({sorted(kinds_now)})")
        # lane death -> debounce-free auto capture of a POD bundle
        podg.kill_host("g1")
        names = [n for n in os.listdir(inc_tmp)
                 if n.startswith("incident-") and n.endswith(".json")]
        check(names, "phaseG: lane death auto-captured no bundle")
        lane_death_bundle = None
        for nme in sorted(names):
            with open(os.path.join(inc_tmp, nme)) as f:
                b = json.load(f)
            bad = obs.validate_bundle(b)
            check(not bad, f"phaseG: bundle {nme} invalid: {bad}")
            if str(b.get("reason", "")).startswith("lane_death"):
                lane_death_bundle = b
        check(lane_death_bundle is not None,
              f"phaseG: no lane_death bundle among {sorted(names)}")
        if lane_death_bundle is not None:
            check(lane_death_bundle["kind"] == "pod",
                  "phaseG: lane-death capture is not a pod bundle")
            tl_kinds = {e["kind"]
                        for e in lane_death_bundle["timeline"]}
            check({"fault.fired", "lane.death"} <= tl_kinds,
                  f"phaseG: pod timeline missing fault/lane-death "
                  f"events ({sorted(tl_kinds)})")
            bundle_errs = [
                t for sub in lane_death_bundle["hosts"].values()
                for t in (sub or {}).get("traces", ())
                if t.get("reason") == "error"]
            check(any(t["trace_id"] == err_traces[0]["trace_id"]
                      for t in bundle_errs) if err_traces else False,
                  "phaseG: typed failure's retained trace missing "
                  "from the auto-captured bundle")
        # the pod keeps serving after the capture
        w = vals()
        got = podg.submit_backward(osig, w).result(timeout=60)
        check(_same(got, oplan.backward(w)),
              "phaseG: post-capture request diverged on the survivor")
        # G2: the capture path itself fails CONTAINED under its fault
        cap_plan = FaultPlan(script="obs.capture@1")
        faults.arm(cap_plan)
        check(obs.capture_incident("chaos-g2") is None,
              "phaseG: faulted capture did not fail contained")
        faults.disarm()
        tally(cap_plan)
        torn = [n for n in os.listdir(inc_tmp) if n.endswith(".tmp")]
        check(not torn,
              f"phaseG: faulted capture left torn files: {torn}")
        # the capture path heals, with BOTH outcomes journalled
        path_g = obs.capture_incident("chaos-g2")
        check(path_g is not None, "phaseG: clean capture failed")
        if path_g is not None:
            with open(path_g) as f:
                healed = json.load(f)
            bad = obs.validate_bundle(healed)
            check(not bad, f"phaseG: healed bundle invalid: {bad}")
            cap_events = [e for e in healed["events"]
                          if e["kind"] == "incident.capture"]
            outcomes = {e["attrs"]["outcome"].split(":")[0]
                        for e in cap_events}
            check({"failed", "written"} <= outcomes,
                  f"phaseG: capture outcomes not journalled "
                  f"({sorted(outcomes)})")
            fired_ev = {e["attrs"]["site"] for e in healed["events"]
                        if e["kind"] == "fault.fired"}
            check("obs.capture" in fired_ev,
                  f"phaseG: obs.capture firing not journalled "
                  f"({sorted(fired_ev)})")
        for plan_g in g_plans:
            tally(plan_g)
        phases["G_flight_recorder"] = {
            "bundles": len(names),
            "retained_error_traces": len(err_traces),
            "stats": obs.recorder_stats()}
    finally:
        faults.disarm()
        podg.close()
        for _, ex_g in lanes_g:
            ex_g.close()
        obs.disable_recorder()
        shutil.rmtree(inc_tmp, ignore_errors=True)
    spans_closed("phaseG")

    subsystems = sorted({subsystem_of[s] for s in fired_sites
                         if s in subsystem_of}
                        | ({"kernel"} if "kernel.launch" in fired_sites
                           else set()))
    check(len(fired_sites) >= 23,
          f"chaos coverage: only {len(fired_sites)} fault sites fired "
          f"({sorted(fired_sites)})")
    check(len(subsystems) >= 10,
          f"chaos coverage: only {len(subsystems)} subsystems hit "
          f"({subsystems})")
    check({"net", "blob", "membership", "obs"} <= set(subsystems),
          f"chaos coverage: wire/recorder subsystems not exercised "
          f"({subsystems})")

    ok = not failures
    print(f"chaos: seed={seed} storms={storms}+{wire_storms} wire "
          f"wave={wave} precision={args.precision}")
    for name, p in phases.items():
        print(f"  {name}: {p}")
    print(f"  sites fired ({len(fired_sites)}): "
          f"{ {s: c for s, c in sorted(fired_sites.items())} }")
    print(f"  subsystems: {subsystems}")
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    result = {
        "metric": f"serve.bench --chaos (5 ladders + {storms} seeded "
                  f"storms + {wire_storms} wire storms + flight-"
                  f"recorder phase over {len(fired_sites)} fault "
                  f"sites)",
        "value": 1 if ok else 0,
        "unit": "ok",
        "chaos": True,
        "ok": ok,
        "seed": seed,
        "failures": failures,
        "phases": phases,
        "fired_sites": fired_sites,
        "subsystems": subsystems,
        "storms": storm_log,
    }
    print(json.dumps(result, default=str))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2, default=str)
        print(f"wrote {args.output}")
    return 0 if ok else 1


def _draw_trace(args, rng, nvs) -> list:
    """The request trace, ``(signature index, values, priority)`` per
    request, in the JAX bench's order of numpy calls, so that both
    packages draw the same trace from one seed."""
    trace = []
    for _ in range(args.requests):
        which = int(rng.integers(len(nvs)))
        nv = nvs[which]
        vals = rng.standard_normal((nv, 2)).astype(np.float32) \
            if args.precision == "single" \
            else (rng.standard_normal(nv)
                  + 1j * rng.standard_normal(nv))
        priority = ("high" if rng.random() < args.high_fraction
                    else "normal")
        trace.append((which, vals, priority))
    return trace


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if args.requests < 1 or args.signatures < 1 or args.threads < 1:
        print("error: --requests, --signatures and --threads must be "
              ">= 1", file=sys.stderr)
        return 2
    if not 0.0 <= args.high_fraction <= 1.0:
        print("error: --high-fraction must be in [0, 1]",
              file=sys.stderr)
        return 2
    if not 0.0 <= args.fault_rate <= 1.0:
        print("error: --fault-rate must be in [0, 1]", file=sys.stderr)
        return 2
    if args.verify_sample < 0:
        print("error: --verify-sample must be >= 0", file=sys.stderr)
        return 2
    from ..errors import DeviceError
    try:
        device = _device(args)
    except DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1

    if args.smoke:
        return _run_smoke(args)
    if args.fault_smoke:
        return _run_fault_smoke(args)
    if args.chaos is not None:
        return _run_chaos(args)

    import threading

    from ..benchmark import cutoff_stick_triplets
    from ..types import TransformType
    from ..utils.platform import platform_summary
    from .executor import ServeExecutor
    from .metrics import ServeMetrics
    from .registry import PlanRegistry

    n = args.dim
    rng = np.random.default_rng(args.seed)

    # S signatures: same grid, S distinct sparsities (distinct sparse
    # sets => distinct digests => distinct plans).
    sparsities = [1.0 - 0.25 * s / max(args.signatures, 1)
                  for s in range(args.signatures)]
    specs = []
    for sp in sparsities:
        triplets = cutoff_stick_triplets(n, n, n, sp, hermitian=False)
        specs.append({"transform_type": TransformType.C2C,
                      "dim_x": n, "dim_y": n, "dim_z": n,
                      "triplets": triplets,
                      "precision": args.precision, "device": device})

    registry = PlanRegistry()
    t0 = time.perf_counter()
    sigs = registry.warmup(specs, compile=True)
    warmup_s = time.perf_counter() - t0

    # the request trace: per-request signature choice + value array +
    # priority class (deterministic from the seed)
    plans = [registry.get(sig) for sig in sigs]
    t0 = time.perf_counter()
    trace = _draw_trace(args, rng, [p.index_plan.num_values
                                    for p in plans])
    print(f"trace: {len(trace)} requests ready in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

    # -- serial-loop baseline: a caller WITHOUT the serving layer. It
    # hand-builds its own plan per signature at first use (the cold
    # plan cost the registry exists to amortise: index tables and the
    # plan's device tables) and drives every request synchronously,
    # each result read back before the next call. The WARM re-run of
    # the same loop is measured and disclosed too.
    from ..plan import make_local_plan
    own_plans = {}
    t0 = time.perf_counter()
    for which, vals, _ in trace:
        p = own_plans.get(which)
        if p is None:
            spec = specs[which]
            p = make_local_plan(TransformType.C2C, spec["dim_x"],
                                spec["dim_y"], spec["dim_z"],
                                spec["triplets"],
                                precision=args.precision, device=device)
            own_plans[which] = p
        _block(p.backward(vals))
    serial_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for which, vals, _ in trace:
        _block(own_plans[which].backward(vals))
    warm_loop_s = time.perf_counter() - t0

    # -- executor replay: args.threads submitters, futures gathered
    metrics = ServeMetrics()
    futures = [None] * len(trace)
    pool = _pool(args, device)
    # knob resolution: explicit flags > --config artifact > boot env >
    # declared defaults — all through the executor's typed ServeConfig
    cfg = None
    if args.config:
        from ..control import ServeConfig
        cfg = ServeConfig.load(args.config)
    executor = ServeExecutor(registry, batch_window=args.window,
                             max_batch=args.max_batch,
                             max_queue=args.max_queue,
                             batching=not args.no_batching,
                             devices=pool if len(pool) > 1 else None,
                             pin_after=args.pin_after,
                             metrics=metrics, config=cfg)
    window = executor.config.batch_window
    max_batch = executor.config.max_batch
    pin_after = executor.config.pin_after

    # Warm every (signature, device, batch-shape) executable the replay
    # will dispatch, so the measurement reflects a warm server the same
    # way the serial baseline's plans are warm — plus one burst through
    # the queue itself (the dispatcher path has its own first-time
    # costs: thread start, allocator warmup).
    for w, sig in enumerate(sigs):
        executor.prewarm(sig)
        nv = plans[w].index_plan.num_values
        vals = np.zeros((nv, 2), np.float32) \
            if args.precision == "single" else np.zeros(nv, np.complex128)
        for f in [executor.submit(sig, vals)
                  for _ in range(max_batch)]:
            f.result()
    # the warm phase ends with its pin prewarms: their launches must
    # neither land in the replay's count nor race its reset
    for t in list(executor._prewarm_threads.values()):
        t.join()
    metrics.reset()
    if args.trace_out or args.prom_out:
        # trace the MEASURED replay only (the warm phase's spans would
        # drown it); enabling after warmup also keeps the baseline and
        # warm loop untraced, so the A/B stays clean
        from .. import obs
        obs.enable()
        obs.GLOBAL_TRACER.reset()
    profiler = None
    if args.profile_dir:
        # the host's ops and, on the card, every kernel of the replay
        # (open trace.json in Perfetto / chrome://tracing)
        try:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
        except Exception as exc:
            profiler = None
            print(f"warning: torch.profiler capture unavailable: {exc}",
                  file=sys.stderr)
    # Fault injection arms AFTER the warm phase: the measured replay
    # degrades, the baseline and warmup stay clean — that's the A/B the
    # acceptance criterion wants (graceful degradation vs collapse).
    fault_plan = None
    if args.fault_rate > 0.0 or args.fault_script:
        from .faults import FaultPlan
        fault_plan = FaultPlan(rate=args.fault_rate, seed=args.seed,
                               scope=args.fault_scope,
                               script=args.fault_script)
        executor.inject_faults(fault_plan)
    # opt-in scrape endpoint + control plane around the MEASURED replay
    metrics_server = None
    mport = _metrics_port(args)
    if mport is not None:
        from ..obs.http import MetricsServer
        metrics_server = MetricsServer(executor=executor, port=mport)
        print(f"metrics endpoint: "
              f"http://127.0.0.1:{metrics_server.start()}/metrics "
              f"(also /healthz, /configz)")
    watchdog = None
    if args.slo:
        from ..control import SLOSpec, SLOWatchdog
        watchdog = SLOWatchdog(metrics, SLOSpec.parse(args.slo))
    controller = control_loop = None
    if args.control:
        from ..control import Controller, ControlLoop
        controller = Controller(executor.config, metrics=metrics,
                                executor=executor, watchdog=watchdog)
        control_loop = ControlLoop(controller,
                                   interval=args.control_interval)
        control_loop.start()
    lock = threading.Lock()
    cursor = [0]

    def submitter():
        while True:
            with lock:
                i = cursor[0]
                if i >= len(trace):
                    return
                cursor[0] += 1
            which, vals, priority = trace[i]
            futures[i] = executor.submit(sigs[which], vals,
                                         priority=priority)

    launches0 = _launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter)
               for _ in range(args.threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed_requests = 0
    for f in futures:
        try:
            _block(f.result(timeout=120))
        except Exception:
            failed_requests += 1
    served_s = time.perf_counter() - t0
    if control_loop is not None:
        control_loop.stop()
    executor.close()
    launches = {k: v - launches0[k] for k, v in _launch_counts().items()}
    slo_final = watchdog.evaluate() if watchdog is not None else None
    if metrics_server is not None:
        metrics_server.stop()
    if profiler is not None:
        try:
            import os
            profiler.__exit__(None, None, None)
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            profiler.export_chrome_trace(path)
            print(f"wrote torch.profiler trace to {path}")
        except Exception as exc:
            print(f"warning: torch.profiler stop failed: {exc}",
                  file=sys.stderr)
    verify = None
    if args.verify_sample:
        verify = _verify_replay(args, device, trace, futures, own_plans,
                                metrics, launches)

    obs_failures = []
    obs_summary = _finish_obs(args, obs_failures, metrics=metrics,
                              registry=registry)
    for msg in obs_failures:
        print(f"warning: obs: {msg}", file=sys.stderr)

    # the ONE consistent snapshot (ServeMetrics.to_json) — also what
    # obs.prometheus_text renders; bench no longer hand-builds its own
    snap = json.loads(metrics.to_json(registry))
    lat = snap["latency_seconds"]
    by_class = snap["latency_seconds_by_class"]
    overhead = snap["overhead_seconds"]
    throughput = len(trace) / served_s
    serial_throughput = len(trace) / serial_s
    warm_loop_throughput = len(trace) / warm_loop_s
    reg = snap["registry"]

    print(f"signatures={len(sigs)} requests={len(trace)} "
          f"threads={args.threads} dim={n}^3 "
          f"precision={args.precision} "
          f"batching={'off' if args.no_batching else 'on'} "
          f"window={window * 1e3:.1f}ms max_batch={max_batch} "
          f"pin_after={pin_after} device_pool={len(pool)}")
    print(f"warmup: {warmup_s:.2f}s for {len(sigs)} plans "
          f"(registry builds={reg['builds']}, "
          f"bytes={reg['bytes_in_use'] / 1e6:.1f} MB)")
    print(f"serial loop : {serial_s:.3f}s  {serial_throughput:8.1f} "
          f"req/s  (hand-built plans, synchronous — no serving layer)")
    print(f"  warm rerun: {warm_loop_s:.3f}s  {warm_loop_throughput:8.1f} "
          f"req/s  (same loop, plans warm)")
    print(f"executor    : {served_s:.3f}s  {throughput:8.1f} req/s  "
          f"(speedup {throughput / serial_throughput:.2f}x vs serial, "
          f"{throughput / warm_loop_throughput:.2f}x vs warm loop)")
    print(f"latency p50/p95/p99: {lat['p50'] * 1e3:.2f} / "
          f"{lat['p95'] * 1e3:.2f} / {lat['p99'] * 1e3:.2f} ms")
    if args.high_fraction > 0:
        hi, no = by_class["high"], by_class["normal"]
        print(f"  high  lane p50/p99: {hi['p50'] * 1e3:.2f} / "
              f"{hi['p99'] * 1e3:.2f} ms "
              f"({snap['completed_by_class']['high']} requests)")
        print(f"  normal lane p50/p99: {no['p50'] * 1e3:.2f} / "
              f"{no['p99'] * 1e3:.2f} ms "
              f"({snap['completed_by_class']['normal']} requests)")
    print(f"batches: fused={snap['fused_batches']} "
          f"serial={snap['serial_batches']} "
          f"pinned={snap['pinned_batches']} "
          f"padded_rows={snap['padded_rows']} "
          f"histogram={snap['batch_size_histogram']}")
    print(f"orchestration: {overhead['per_bucket'] * 1e3:.3f} ms/bucket "
          f"{overhead['per_request'] * 1e3:.3f} ms/request "
          f"(stage {overhead['stage_total'] * 1e3:.1f} ms + dispatch "
          f"{overhead['dispatch_total'] * 1e3:.1f} ms total)")
    print(f"registry hit-rate: {reg['hit_rate'] * 100:.1f}% "
          f"(hits={reg['hits']} misses={reg['misses']} "
          f"evictions={reg['evictions']})")
    health = snap["health"]
    if fault_plan is not None:
        fstats = fault_plan.stats()
        print(f"faults: injected transient={fstats['fired_transient']} "
              f"permanent={fstats['fired_permanent']} "
              f"by_site={fstats['fired_by_site']}")
        print(f"  recovery: retries={health['retries']} "
              f"exhausted={health['retries_exhausted']} "
              f"bucket_fallbacks={health['bucket_fallbacks']} "
              f"failed_requests={failed_requests}")
        print(f"  pool: quarantines={health['quarantines']} "
              f"probations={health['probations']} "
              f"readmissions={health['readmissions']} "
              f"no_healthy_device={health['no_healthy_device']}")
    print(f"health: {health['state']} "
          f"(crashes={health['dispatcher_crashes']} "
          f"restarts={health['dispatcher_restarts']})")
    control_summary = None
    if controller is not None:
        import dataclasses
        control_summary = {
            "steps": controller.steps,
            "decisions": [dataclasses.asdict(d)
                          for d in controller.decisions()],
            "knobs": executor.config.snapshot(),
        }
        print(f"control: {controller.steps} steps, "
              f"{len(control_summary['decisions'])} decisions; final "
              f"window={executor.config.batch_window * 1e3:.2f}ms "
              f"max_batch={executor.config.max_batch} "
              f"pin_after={executor.config.pin_after} "
              f"pipeline_depth={executor.config.pipeline_depth}")
        for d in control_summary["decisions"]:
            print(f"  step {d['step']}: {d['knob']} {d['old']:g} -> "
                  f"{d['new']:g} ({d['reason']})")
    if slo_final is not None:
        print(f"slo: violations={slo_final['violations'] or 'none'} "
              f"burn={ {k: round(v, 3) for k, v in slo_final['burn'].items()} }")

    result = {
        "metric": f"serve.bench {n}^3 x{len(sigs)} signatures, "
                  f"{len(trace)} requests, {args.threads} threads "
                  f"(p50={lat['p50'] * 1e3:.2f}ms "
                  f"p95={lat['p95'] * 1e3:.2f}ms "
                  f"p99={lat['p99'] * 1e3:.2f}ms, "
                  f"fused_batches={snap['fused_batches']}, "
                  f"pinned_batches={snap['pinned_batches']}, "
                  f"padded_rows={snap['padded_rows']}, "
                  f"registry_hit_rate={reg['hit_rate']:.3f})",
        "value": round(throughput, 3),
        "unit": "req/s",
        "throughput_rps": round(throughput, 3),
        "serial_throughput_rps": round(serial_throughput, 3),
        "warm_loop_throughput_rps": round(warm_loop_throughput, 3),
        "speedup_vs_serial": round(throughput / serial_throughput, 3),
        "speedup_vs_warm_loop": round(
            throughput / warm_loop_throughput, 3),
        "registry_hit_rate": round(reg["hit_rate"], 4),
        "high_fraction": args.high_fraction,
        "fault_rate": args.fault_rate,
        "fault_script": args.fault_script,
        "failed_requests": failed_requests,
        "faults": (fault_plan.stats() if fault_plan is not None
                   else None),
        "obs": obs_summary,
        "obs_failures": obs_failures,
        "control": control_summary,
        "slo": slo_final,
        "serve_metrics": snap,
        "platform": platform_summary(device),
    }
    if verify is not None:
        result["verify"] = verify
    print(json.dumps(result))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.output}")
    return 0 if verify is None or verify["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
