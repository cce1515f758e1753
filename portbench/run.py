"""The benchmark of spfft_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit) and the numbers compared as the last lines of standard
error. Exits with another code than 0, and prints no result, where no
CUDA card is visible, where the cell asks for more cards than there are,
and where ``jax``, ``jaxlib``, ``flax`` or ``spfft_tpu`` was imported.
See ``portbench/README.md``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: every build and kernel cache the run may write, at fixed paths inside
#: the checkout (the program builds its own kernels into build/)
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
FORBIDDEN = ("jax", "jaxlib", "flax", "spfft_tpu")


def forbidden_modules() -> list:
    """The top-level names of ``sys.modules`` that the benchmark may not
    hold, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import spec
    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"{cards} visible", file=sys.stderr)
        return 2
    from portbench import harness
    line, checks = harness.run(args.workload, args.seed, args.seconds,
                               bool(args.trace), T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run imported {found}", file=sys.stderr)
        return 3
    report(line, checks)
    return 0


def report(line: dict, checks: list, out=None, err=None) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output."""
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    for c in checks:
        print(f"portbench: {c}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
