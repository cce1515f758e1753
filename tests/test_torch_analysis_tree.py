"""The port's lint engine against the JAX package's over the JAX
package's whole tree: ``spfft_tpu/`` with its docs at the repository
root (``README.md``, ``docs/``) gives the same report from both engines,
finding for finding — 0 errors and the JAX package's 16 waivers."""

import os

import pytest

from spfft_tpu import analysis as janalysis
from spfft_tpu_torch import analysis as tanalysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = os.path.join(REPO, "spfft_tpu")


@pytest.fixture(scope="module")
def reports():
    return [pkg.run_analysis(root=JAX_PACKAGE, docs_root=REPO).to_dict()
            for pkg in (janalysis, tanalysis)]


def test_jax_tree_reports_are_identical(reports):
    jax_report, port_report = reports
    assert port_report == jax_report


def test_jax_tree_is_clean_with_its_16_waivers(reports):
    port_report = reports[1]
    assert port_report["ok"] is True
    assert port_report["summary"] == {"errors": 0, "warnings": 0,
                                      "waivers": 16}
    assert all(w["reason"] for w in port_report["waivers"])
    assert port_report["checkers"] == list(tanalysis.CHECKERS)


@pytest.mark.parametrize("checker", tanalysis.CHECKERS)
def test_jax_tree_findings_per_checker_are_identical(reports, checker):
    """The same comparison checker by checker, so a drift names its
    checker (lock-order findings ride with lock-discipline)."""
    jax_report, port_report = reports

    def rows(report):
        return sorted((f["path"], f["line"], f["message"],
                       f.get("reason", ""))
                      for f in report["findings"] + report["waivers"]
                      if f["checker"] == checker
                      or (checker == "lock-discipline"
                          and f["checker"] == "lock-order"))

    assert rows(port_report) == rows(jax_report)
