"""CLI: ``python -m spfft_tpu_torch.control <tune|show|check>`` (the port
of ``spfft_tpu/control/__main__.py``: the same subcommands, flags and
output).

* ``tune`` — run the offline auto-tuner (serve.bench knob grid, plus
  ``--overlap-ab`` for ``scripts/torch_bench_overlap_ab.py``'s exchange
  A/B) and write the recommended-config artifact the serving layer loads
  at boot. It runs on the card; ``--cpu`` runs the plans on the host, and
  without a card and without ``--cpu`` it exits 1 with the port's
  ``DeviceError``.
* ``show`` — print every knob with its current boot value, bounds,
  default and driving signal (the docs table, live).
* ``check FILE`` — validate a recommended-config artifact (schema +
  knob names + bounds) and print what it would apply.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..errors import InvalidParameterError
from .config import CONFIG_ENV, KNOB_SPECS, ServeConfig


def _cmd_show(args) -> int:
    cfg = ServeConfig.boot()
    values = cfg.snapshot()
    import os
    src = os.environ.get(CONFIG_ENV)
    print(f"boot config source: "
          f"{src if src else f'defaults ({CONFIG_ENV} unset)'}")
    width = max(len(n) for n in KNOB_SPECS)
    for name, spec in KNOB_SPECS.items():
        mark = "" if values[name] == spec.default \
            else f"  (default {spec.default:g})"
        print(f"  {name:<{width}}  = {values[name]:<12g} "
              f"bounds [{spec.lo:g}, {spec.hi:g}]{mark}")
        print(f"  {'':<{width}}    signal: {spec.signal}")
    if args.json:
        print(json.dumps({"values": values,
                          "bounds": {n: [s.lo, s.hi]
                                     for n, s in KNOB_SPECS.items()},
                          "defaults": {n: s.default
                                       for n, s in KNOB_SPECS.items()}}))
    return 0


def _cmd_check(args) -> int:
    try:
        cfg = ServeConfig.load(args.file)
    except InvalidParameterError as exc:
        print(f"INVALID: {exc}", file=sys.stderr)
        return 1
    values = cfg.snapshot()
    changed = {n: v for n, v in values.items()
               if v != KNOB_SPECS[n].default}
    clamped = [d for d in cfg.decisions() if d["clamped"]]
    print(f"{args.file}: valid serve-config artifact")
    print(f"  knobs off default: {changed if changed else 'none'}")
    for d in clamped:
        print(f"  NOTE: {d['knob']} requested {d['requested']:g} was "
              f"clamped to {d['new']:g}")
    print(json.dumps({"ok": True, "values": values,
                      "off_default": changed,
                      "clamped": [d['knob'] for d in clamped]}))
    return 0


def _cmd_tune(args) -> int:
    from ..errors import DeviceError
    from ..plan import resolve_device
    try:
        resolve_device("cpu" if args.cpu else None)
    except DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1
    from .tuner import tune
    artifact = tune(args)
    print(json.dumps({"metric": "control.tune grid "
                               f"dim={args.dim} requests={args.requests}",
                      "value": 1, "unit": "ok",
                      "values": artifact["values"],
                      "best": artifact["provenance"].get("best")}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m spfft_tpu_torch.control")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tune", help="offline auto-tune; writes the "
                                    "recommended-config artifact")
    t.add_argument("--dim", type=int, default=24)
    t.add_argument("--requests", type=int, default=96)
    t.add_argument("--signatures", type=int, default=3)
    t.add_argument("--threads", type=int, default=4)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--quick", action="store_true",
                   help="2x1 grid instead of 4x3 (CI-speed)")
    t.add_argument("--windows-ms", type=float, nargs="+", default=None)
    t.add_argument("--max-batches", type=int, nargs="+", default=None)
    t.add_argument("--p99-slack", type=float, default=0.05,
                   help="throughput slack within which lower p99 wins")
    t.add_argument("--overlap-ab", action="store_true",
                   help="also run scripts/torch_bench_overlap_ab.py to "
                        "pick overlap_chunks (recommends K=1 unless the "
                        "A/B shows overlap, which one card's shards "
                        "never do)")
    t.add_argument("--overlap-dim", type=int, default=48)
    t.add_argument("--cpu", action="store_true",
                   help="run on the host: device='cpu', the kernels' "
                        "plain PyTorch versions")
    t.add_argument("--devices", type=int, default=0,
                   help="the replays' executor pool (serve.bench "
                        "--devices)")
    t.add_argument("-o", "--output", default=None,
                   metavar="CONFIG.json")
    t.set_defaults(func=_cmd_tune)

    s = sub.add_parser("show", help="print knobs, bounds, signals")
    s.add_argument("--json", action="store_true")
    s.set_defaults(func=_cmd_show)

    c = sub.add_parser("check", help="validate a config artifact")
    c.add_argument("file")
    c.set_defaults(func=_cmd_check)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
