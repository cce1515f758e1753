"""Observability CLI: ``python -m spfft_tpu_torch.obs`` (the port of
``spfft_tpu/obs/__main__.py``: the same subcommands, flags, checks and
exit codes).

Four subcommands:

* ``demo`` — record a small fully-traced serving run (registry build,
  deterministic request waves through a ``ServeExecutor``, plus a
  distributed plan of two shards on the one device with two exchange
  chunks, run once) and write the Chrome trace JSON / Prometheus text
  artifacts: ``python -m spfft_tpu_torch.obs demo --trace-out
  /tmp/spfft.trace.json``, then open the file in
  https://ui.perfetto.dev. It runs on the card; ``--cpu`` runs the
  plans' plain versions on the host. The JAX demo's distributed part
  needs two devices and records XLA's HLO counts; the port always has a
  mesh (S shards on one device) and counts launches instead
  (``ops._build.count``), so its demo always builds and runs it.
* ``validate FILE`` — structural validation of an exported trace JSON
  (parses, non-empty, well-formed events, zero open spans recorded);
  ``--require-stage NAME`` (repeatable) additionally demands named
  spans. Exit 1 on any violation.
* ``prom [FILE]`` — with a FILE, round-trip it through the validating
  exposition-format parser; without, print the current process's
  :func:`~spfft_tpu_torch.obs.exporters.prometheus_text`.
* ``incident`` — flight-recorder ops verb: ``--validate FILE``
  schema-checks a captured bundle; otherwise capture one NOW from this
  process (``--dir`` overrides the incident directory) and, with
  repeatable ``--peer [name=]ip:port`` agent addresses, gather every
  peer's bundle over the wire (:class:`~spfft_tpu_torch.net.transport.
  TcpHostLane`) into one pod bundle.
"""


from __future__ import annotations

import argparse
import json
import sys
from typing import List

from . import (GLOBAL_TRACER, enable, export_trace, parse_prometheus_text,
               prometheus_text)

#: The eight per-request pipeline stages every end-to-end trace covers.
REQUEST_STAGES = ("serve.submit", "serve.queue_wait",
                  "serve.bucket_formation", "serve.stage",
                  "serve.dispatch", "serve.device_execute",
                  "serve.materialise", "serve.resolve")


def validate_trace_payload(payload: dict,
                           require_names=()) -> List[str]:
    """Structural checks over an exported Chrome trace payload; returns
    a list of failure messages (empty = valid)."""
    failures: List[str] = []
    events = payload.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    tracks = {}
    names = set()
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "M"):
            failures.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            if ev.get("name") == "thread_name":
                tracks.setdefault(ev.get("tid"),
                                  {"name": ev["args"]["name"],
                                   "events": 0})
            continue
        if not isinstance(ev.get("name"), str) or "ts" not in ev:
            failures.append(f"event {i}: missing name/ts")
            continue
        names.add(ev["name"])
        if ev.get("tid") in tracks:
            tracks[ev["tid"]]["events"] += 1
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                failures.append(
                    f"event {i} ({ev['name']}): bad dur {dur!r}")
    for tid, info in tracks.items():
        if info["events"] == 0:
            failures.append(
                f"track {info['name']!r} (tid {tid}) declared but "
                f"empty")
    for name in require_names:
        if name not in names:
            failures.append(f"required span {name!r} missing from trace")
    stats = (payload.get("otherData") or {}).get("tracer") or {}
    if stats.get("open", 0):
        failures.append(f"tracer recorded {stats['open']} unclosed "
                        f"spans at export time")
    return failures


def _cmd_demo(args) -> int:
    from ..errors import DeviceError
    from ..plan import resolve_device
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1
    enable()
    GLOBAL_TRACER.reset()

    import numpy as np

    from ..benchmark import cutoff_stick_triplets
    from ..parallel import make_distributed_plan, make_mesh
    from ..serve.executor import ServeExecutor
    from ..serve.registry import PlanRegistry
    from ..types import TransformType
    from ..utils.workloads import (even_plane_split,
                                   round_robin_stick_partition)

    n = args.dim
    triplets = cutoff_stick_triplets(n, n, n, 0.9, hermitian=False)
    registry = PlanRegistry()
    sig, plan = registry.get_or_build(TransformType.C2C, n, n, n,
                                      triplets, device=device)
    nv = plan.index_plan.num_values
    rng = np.random.default_rng(0)
    pool = [device] * args.devices if args.devices > 1 else None
    ex = ServeExecutor(registry, autostart=False, batch_window=0.0,
                       devices=pool)
    waves, wave = max(1, args.requests // 4), 4
    for _ in range(waves):
        futures = [ex.submit(
            sig, rng.standard_normal((nv, 2)).astype(np.float32))
            for _ in range(wave)]
        ex._drain_once()
        for f in futures:
            f.result(timeout=60)
    snap = ex.metrics
    # the exchange's accounting: two shards on the one device, two
    # chunks (exchange.plan_build and the per-chunk wire series at
    # construction), then one backward through the exchange
    S = 2
    parts = round_robin_stick_partition(triplets, (n, n, n), S)
    planes = even_plane_split(n, S)
    dplan = make_distributed_plan(TransformType.C2C, n, n, n, parts,
                                  planes, mesh=make_mesh(S, device),
                                  overlap_chunks=2)
    dplan.backward([np.zeros(len(p), np.complex64) for p in parts])
    del dplan
    ex.close()
    open_spans = GLOBAL_TRACER.open_count()
    if args.trace_out:
        payload = export_trace(args.trace_out)
        failures = validate_trace_payload(payload,
                                          require_names=REQUEST_STAGES)
        print(f"wrote {args.trace_out} "
              f"({len(payload['traceEvents'])} events) — open it in "
              f"https://ui.perfetto.dev")
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        if failures:
            return 1
    text = prometheus_text(metrics=snap, registry=registry)
    parse_prometheus_text(text)  # self-check
    if args.prom_out:
        with open(args.prom_out, "w") as f:
            f.write(text)
        print(f"wrote {args.prom_out} ({len(text.splitlines())} lines)")
    elif not args.trace_out:
        print(text, end="")
    if open_spans:
        print(f"FAIL: {open_spans} spans left open", file=sys.stderr)
        return 1
    return 0


def _cmd_validate(args) -> int:
    with open(args.file) as f:
        try:
            payload = json.load(f)
        except json.JSONDecodeError as exc:
            print(f"FAIL: {args.file} is not JSON: {exc}",
                  file=sys.stderr)
            return 1
    require = list(args.require_stage or [])
    if args.require_request_stages:
        require.extend(REQUEST_STAGES)
    failures = validate_trace_payload(payload, require_names=require)
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    if not failures:
        events = payload.get("traceEvents", [])
        print(f"ok: {args.file} ({len(events)} events)")
    return 1 if failures else 0


def _cmd_prom(args) -> int:
    if args.file:
        with open(args.file) as f:
            text = f.read()
        try:
            series = parse_prometheus_text(text)
        except ValueError as exc:
            print(f"FAIL: {args.file}: {exc}", file=sys.stderr)
            return 1
        print(f"ok: {args.file} ({len(series)} series)")
        return 0
    print(prometheus_text(), end="")
    return 0


def _cmd_incident(args) -> int:
    from . import recorder
    if args.validate:
        try:
            with open(args.validate) as f:
                bundle = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"FAIL: {args.validate}: {exc}", file=sys.stderr)
            return 1
        failures = recorder.validate_bundle(bundle)
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        if failures:
            return 1
        hosts = sorted(bundle.get("hosts") or ())
        detail = f", hosts: {', '.join(hosts)}" if hosts else ""
        print(f"ok: {args.validate} ({bundle.get('kind')} bundle, "
              f"{len(bundle.get('timeline') or bundle.get('events') or ())}"
              f" events{detail})")
        return 0
    if not recorder.recorder_active():
        recorder.enable_recorder(incident_dir=args.dir, auto=False)
    reason = args.reason
    if args.peer:
        from ..net.transport import TcpHostLane
        bundles = {args.host: recorder.build_incident_bundle(
            reason, host=args.host)}
        for spec in args.peer:
            name, _, addr = spec.rpartition("=")
            ip, _, port = addr.rpartition(":")
            name = name or addr
            try:
                lane = TcpHostLane(name, (ip or "127.0.0.1", int(port)))
            except (OSError, ValueError) as exc:
                bundles[name] = {"error": f"{type(exc).__name__}: {exc}"}
                continue
            try:
                bundles[name] = lane.rpc_incident(reason)
            except Exception as exc:
                bundles[name] = {"error": f"{type(exc).__name__}: {exc}"}
            finally:
                close = getattr(lane, "close", None)
                if close is not None:
                    close()
        pod = recorder.merge_pod_bundle(reason, bundles)
        try:
            path = recorder.write_bundle(pod, directory=args.dir)
        except Exception as exc:
            print(f"FAIL: bundle write failed: {exc}", file=sys.stderr)
            return 1
    else:
        path = recorder.capture_incident(reason, directory=args.dir)
        if path is None:
            print("FAIL: incident capture failed (no incident dir? "
                  "pass --dir)", file=sys.stderr)
            return 1
    with open(path) as f:
        failures = recorder.validate_bundle(json.load(f))
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    print(f"wrote {path}")
    return 1 if failures else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.obs",
        description="spfft_tpu_torch observability: trace/metrics "
                    "exporters")
    sub = p.add_subparsers(dest="cmd", required=True)

    demo = sub.add_parser("demo", help="record a small traced serving "
                                       "run and export artifacts")
    demo.add_argument("--dim", type=int, default=12)
    demo.add_argument("--requests", type=int, default=16)
    demo.add_argument("--trace-out", default=None, metavar="FILE.json")
    demo.add_argument("--prom-out", default=None, metavar="FILE.prom")
    demo.add_argument("--cpu", action="store_true",
                      help="run on the host: device='cpu', the kernels' "
                           "plain PyTorch versions")
    demo.add_argument("--devices", type=int, default=0,
                      help="the executor's pool: N slots of the device "
                           "(default: the plan's device alone)")

    val = sub.add_parser("validate",
                         help="structurally validate a trace JSON")
    val.add_argument("file")
    val.add_argument("--require-stage", action="append", default=[])
    val.add_argument("--require-request-stages", action="store_true",
                     help="demand all eight per-request pipeline "
                          "stages")

    prom = sub.add_parser("prom", help="print (or validate) Prometheus "
                                       "exposition text")
    prom.add_argument("file", nargs="?", default=None)

    inc = sub.add_parser("incident",
                         help="capture or validate a flight-recorder "
                              "incident bundle")
    inc.add_argument("--validate", default=None, metavar="FILE.json",
                     help="schema-check a captured bundle instead of "
                          "capturing")
    inc.add_argument("--dir", default=None,
                     help="incident directory (default: "
                          "SPFFT_TPU_INCIDENT_DIR)")
    inc.add_argument("--reason", default="cli")
    inc.add_argument("--host", default="local",
                     help="host label for this process's bundle")
    inc.add_argument("--peer", action="append", default=[],
                     metavar="[NAME=]IP:PORT",
                     help="agent address to gather into a pod bundle "
                          "(repeatable)")

    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    if args.cmd == "demo":
        return _cmd_demo(args)
    if args.cmd == "validate":
        return _cmd_validate(args)
    if args.cmd == "incident":
        return _cmd_incident(args)
    return _cmd_prom(args)


if __name__ == "__main__":
    sys.exit(main())
