"""The readings a cell's limits are set from, in one process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 2

For each of ``--seeds`` a run of the cell (``harness.run``: its set-up,
a measured window of ``--seconds`` at the cell's own load, the check
against the reference) gives the program's readings of the numbers
compared. For each of ``--control-seeds`` the control takes the
program's place on the same inputs and gives its readings: for a
float64 configuration the program's own float32 path (the configuration
with ``precision`` single), for a float32 one the reference computed in
TF32 (``reference.dense.control_pair``). Prints one JSON line a reading
and last the largest program reading and the smallest control reading of
each number. A program run that left the fused route (a direction
demoted, as a device failure demotes it) is no sound run: its reading is
printed and sets no lower reading. The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec, workload
    from portbench.reference import dense
    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    cfg = cell.config
    device = torch.device(args.device or "cuda")
    program, control = [], []

    def emit(kind, seed, checks):
        rec = {"workload": args.workload, "kind": kind, "seed": seed}
        rec.update({c: checks[c]["value"] for c in harness.CHECKS})
        if "fused_demotions" in checks:
            rec["fused_demotions"] = checks["fused_demotions"]["value"]
        print(json.dumps(rec), flush=True)
        return rec

    for seed in (int(s) for s in args.seeds.split(",")):
        line, _ = harness.run(args.workload, seed, args.seconds, False,
                              time.perf_counter(), device=device)
        rec = emit("program", seed, line["checks"])
        if not rec["fused_demotions"]:
            program.append(rec)
    for seed in (int(s) for s in args.control_seeds.split(",")):
        if cfg["precision"] == "double":
            low = dict(cfg, precision="single")
            line, _ = harness.run(args.workload, seed, args.seconds, False,
                                  time.perf_counter(), device=device,
                                  config=low)
            control.append(emit("control_program_single", seed,
                                line["checks"]))
            continue
        trip = workload.config_triplets(cfg)
        values, potential = workload.draw_inputs(cfg, trip, seed, device)
        idx = torch.as_tensor(workload.storage_indices(trip, cfg["dims"]),
                              device=device)
        per = {}
        for b in range(values.shape[0]):
            out = dense.control_pair(values[b], potential, idx, cfg["dims"],
                                     cfg["transform"] == "r2c")
            per.update(harness.compare({b: out}, values, potential, trip,
                                       cfg))
        _, _, checks = harness.judge(per, values.shape[0], cfg["limits"])
        control.append(emit("control_reference_tf32", seed, checks))
        del values, potential, idx
    summary = {"workload": args.workload, "summary": True,
               "sound_program_runs": len(program)}
    for c in harness.CHECKS:
        summary[f"{c}_program_max"] = max(r[c] for r in program)
        summary[f"{c}_control_min"] = min(r[c] for r in control)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
