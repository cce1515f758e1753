"""Whole runs of each cell on the CPU at a small size: the contract's
last line, and ``correct`` false under a broken program (the faults a
cell can have) and under the control."""

import io
import json
import time

import pytest
import torch

import spfft_tpu_torch
from portbench import harness, run, spec
from portbench_support import ROOT, small_config

BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_run(cell, trace=False, config=None, seed=2**31 + 3):
    c = spec.Cell(BENCH, cell)
    cfg = config or small_config(c.config["name"])
    return harness.run(cell, seed, 1.0, trace, time.perf_counter(),
                       device="cpu", bench=BENCH, config=cfg)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_ends_with_the_result_line(cell, trace):
    line, checks = small_run(cell, bool(trace))
    out, err = io.StringIO(), io.StringIO()
    run.report(line, checks, out, err)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last)[:5] == KEYS and list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    assert set(last["checks"]) == {"band_rel_l2", "value_err_rms",
                                   "bands_missing", "fused_demotions"}
    tail = err.getvalue().strip().splitlines()[-4:]
    assert all(s.startswith("portbench: check ") and " limit " in s
               for s in tail)
    if trace:
        # no device on the CPU: only the host's metrics can be read
        assert set(last["metrics"]) == {"dispatch_ms_per_call",
                                        "plan_build_s"}
        assert "breakdown" in last
    else:
        assert set(last["metrics"]) == {"pairs_per_s", "call_p95_ms",
                                        "setup_s"}
        assert all(m["value"] > 0 for m in last["metrics"].values())


def _break_multi(monkeypatch, fault):
    real_bwd = spfft_tpu_torch.multi.multi_transform_backward
    real_fwd = spfft_tpu_torch.multi.multi_transform_forward
    seen = {}

    def bwd(transforms, values):
        seen["values"] = values
        return real_bwd(transforms, values)

    def fwd(transforms, spaces, scalings):
        if fault == "unchanged":  # the pair hands back its input
            return [v.clone() for v in seen["values"]]
        outs = real_fwd(transforms, spaces, scalings)
        if fault == "half_batch":  # the second half is never computed
            h = len(outs) // 2
            return outs[:h] + [o.clone() for o in outs[:h]]
        outs[0][3] += 1.0  # an answer altered where it is produced
        return outs

    monkeypatch.setattr(spfft_tpu_torch.multi, "multi_transform_backward",
                        bwd)
    monkeypatch.setattr(spfft_tpu_torch.multi, "multi_transform_forward",
                        fwd)


def _break_transform(monkeypatch, fault):
    cls = spfft_tpu_torch.grid.Transform
    real_bwd, real_fwd = cls.backward, cls.forward

    def bwd(self, values):
        self._bench_values = values
        return real_bwd(self, values)

    def fwd(self, space=None, scaling=None):
        if fault == "unchanged":
            return self._bench_values.clone()
        out = real_fwd(self, space, scaling)
        out[3] += 1.0
        return out

    monkeypatch.setattr(cls, "backward", bwd)
    monkeypatch.setattr(cls, "forward", fwd)


FAULTS = [(c, f) for c in CELLS
          for f in (("unchanged", "half_batch", "altered")
                    if c.endswith("bands_b8") else ("unchanged", "altered"))]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    if cell.endswith("bands_b8"):
        _break_multi(monkeypatch, fault)
    else:
        _break_transform(monkeypatch, fault)
    line, _ = small_run(cell)
    assert line["correct"] is False
    assert line["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_demoted_route_is_not_correct(cell, monkeypatch):
    """A run whose plan left the fused route, as a device failure demotes
    it, reads ``correct`` false though its outputs are right."""
    cls = spfft_tpu_torch.plan.TransformPlan
    monkeypatch.setattr(cls, "fused_demotions", lambda self: {
        "dec": {"reason": "runtime: OutOfMemoryError", "permanent": False}})
    line, _ = small_run(cell)
    assert line["correct"] is False
    assert line["checks"]["fused_demotions"] == {"value": 1, "limit": 0}
    assert line["checks"]["band_rel_l2"]["value"] \
        <= line["checks"]["band_rel_l2"]["limit"]


def test_compare_reads_the_plan_s_layout():
    """A plan of 16,000,000 values or more returns its values planar,
    ``(2, N)`` (``pair_values_io``): the check reads that layout only
    where the plan states it."""
    from portbench.reference import dense
    cfg = small_config("c2c256_f32", bands=1)
    trip = harness.workload.config_triplets(cfg)
    values, pot = harness.workload.draw_inputs(cfg, trip, 3, "cpu")
    idx = torch.as_tensor(harness.workload.storage_indices(
        trip, cfg["dims"]))
    ref = dense.reference_pair(values[0], pot, idx, cfg["dims"], False)
    planar = {0: ref.t().contiguous().float()}
    ok = harness.compare(planar, values, pot, trip, cfg, pair=True)[0]
    assert ok[0] < 1e-6
    assert harness.compare(planar, values, pot, trip, cfg)[0] == \
        (float("inf"), float("inf"))
    assert harness.compare({0: ref.float()}, values, pot, trip, cfg,
                           pair=True)[0] == (float("inf"), float("inf"))


def test_control_is_not_correct_c2c_tf32(monkeypatch):
    """The float32 configuration's control: the reference in TF32 in the
    program's place."""
    from portbench.reference import dense
    cfg = small_config("c2c256_f32", n=32, bands=8)
    real = harness.compare

    def compare(outputs, values, potential, trip, cfg_, pair=False):
        idx = torch.as_tensor(harness.workload.storage_indices(
            trip, cfg_["dims"]))
        ctl = {b: dense.control_pair(values[b], potential, idx,
                                     cfg_["dims"], False) for b in outputs}
        return real(ctl, values, potential, trip, cfg_)

    monkeypatch.setattr(harness, "compare", compare)
    line, _ = small_run("c2c256_f32.bands_b8", config=cfg)
    assert line["correct"] is False
    assert line["checks"]["band_rel_l2"]["value"] \
        > line["checks"]["band_rel_l2"]["limit"]


def test_control_is_not_correct_r2c_single():
    """The float64 configuration's control: the program's own float32
    path."""
    cfg = small_config("r2c256_f64")
    cfg["precision"] = "single"
    line, _ = small_run("r2c256_f64.bands_b8", config=cfg)
    assert line["correct"] is False
    assert line["checks"]["band_rel_l2"]["value"] \
        > line["checks"]["band_rel_l2"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    line, _ = harness.run(cell, 2**31 + 77, 2.0, False, time.perf_counter(),
                          bench=BENCH)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
