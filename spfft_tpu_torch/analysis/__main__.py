"""CLI: ``python -m spfft_tpu_torch.analysis`` — run the port's project
lint engine.

Exit status: 0 when every checker passes (waived findings are listed
but do not fail), 1 on any unwaived error, 2 on usage errors.

Examples::

    python -m spfft_tpu_torch.analysis                     # all checkers
    python -m spfft_tpu_torch.analysis --json report.json  # machine output
    python -m spfft_tpu_torch.analysis --checker lock-discipline \\
                                       --checker span-closure
    python -m spfft_tpu_torch.analysis --baseline-only     # the lint half
    python -m spfft_tpu_torch.analysis --root spfft_tpu --docs-root .
"""

from __future__ import annotations

import argparse
import json
import sys

from . import CHECKERS, PORT_DOCS, run_analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.analysis",
        description="spfft_tpu_torch project lint engine "
                    f"({PORT_DOCS}/static_analysis.md)")
    ap.add_argument("--root", default=None,
                    help="package directory to analyze (default: the "
                         "installed spfft_tpu_torch package)")
    ap.add_argument("--docs-root", default=None,
                    help="repo root holding docs/ and README.md, read as "
                         f"the JAX engine reads them (default: {PORT_DOCS}/ "
                         "beside the package)")
    ap.add_argument("--checker", action="append", default=None,
                    choices=list(CHECKERS), dest="checkers",
                    help="run only the named checker (repeatable)")
    ap.add_argument("--baseline-only", action="store_true",
                    help="run only the baseline lint")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the machine-readable report here")
    ap.add_argument("--list", action="store_true",
                    help="list available checkers and exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the human-readable report on "
                         "success")
    args = ap.parse_args(argv)

    if args.list:
        for name in CHECKERS:
            print(name)
        return 0
    checkers = args.checkers
    if args.baseline_only:
        checkers = ["baseline-lint"]
    try:
        report = run_analysis(root=args.root, checkers=checkers,
                              docs_root=args.docs_root)
    except (OSError, SyntaxError, ValueError) as exc:
        print(f"analysis failed: {exc}", file=sys.stderr)
        return 2
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
    if report.ok() and args.quiet:
        return 0
    print(report.text())
    return 0 if report.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
