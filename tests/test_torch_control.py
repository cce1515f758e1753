"""The port's control loop (``spfft_tpu_torch.control``: the controller,
the SLO watchdog, the tuner's scoring and the ``control`` CLI) against
the JAX package's on the CPU.

Every controller scenario of ``tests/test_control_plane.py`` runs here
on the port (scripted signals, and the executor on ``device="cpu"``
where a scenario needs one). The differential feeds seeded signal
sequences (idle, backlog, drained, pad-heavy, reject, exposed and
hidden exchange, SPMD, RTT and staging stretches) through the JAX
``Controller`` and the port's: the decision lists (step, knob, old, new,
reason) and the final knobs must be equal exactly, as must the
watchdog's verdicts, ``SLOSpec.parse`` on every form, ``_score_grid`` on
the same cells and the CLI's ``show --json`` / ``check`` output.
"""

import copy
import json
import threading
import time

import numpy as np
import pytest
import torch

from spfft_tpu import control as jcontrol
from spfft_tpu import obs as jobs
from spfft_tpu.control import __main__ as jcli
from spfft_tpu.control import config as jcfg
from spfft_tpu.control import tuner as jtuner
from spfft_tpu.errors import InvalidParameterError as JInvalid

import spfft_tpu_torch as sp
from spfft_tpu_torch import control, obs
from spfft_tpu_torch.control import (KNOB_SPECS, MANAGED_KNOBS, ControlLoop,
                                     Controller, ServeConfig, SLOSpec,
                                     SLOWatchdog)
from spfft_tpu_torch.control import __main__ as cli
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.control import tuner
from spfft_tpu_torch.errors import InvalidParameterError
from spfft_tpu_torch.serve import PlanRegistry, ServeExecutor, ServeMetrics

from test_util import random_sparse_triplets

torch.set_num_threads(2)

DIMS = (12, 13, 11)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(tcfg.CONFIG_ENV, raising=False)

    def reset():
        for c, o in ((tcfg, obs), (jcfg, jobs)):
            c.set_global_config(None)
            o.GLOBAL_COUNTERS.reset()
    reset()
    yield
    reset()


def _registry():
    reg = PlanRegistry(store=False)
    rng = np.random.default_rng(3)
    t = random_sparse_triplets(rng, DIMS)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, *DIMS, t,
                                 precision="double", device="cpu")
    return reg, sig, plan


def _values(plan, rng):
    n = plan.index_plan.num_values
    return rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)


def test_package_exports_equal_jax():
    assert control.__all__ == jcontrol.__all__
    assert MANAGED_KNOBS == jcontrol.MANAGED_KNOBS
    import dataclasses
    assert [f.name for f in dataclasses.fields(control.Decision)] == \
        [f.name for f in dataclasses.fields(jcontrol.Decision)]
    assert tuner.DEFAULT_WINDOWS_MS == jtuner.DEFAULT_WINDOWS_MS
    assert tuner.DEFAULT_MAX_BATCHES == jtuner.DEFAULT_MAX_BATCHES
    assert tuner.QUICK_WINDOWS_MS == jtuner.QUICK_WINDOWS_MS
    assert tuner.QUICK_MAX_BATCHES == jtuner.QUICK_MAX_BATCHES


# -- controller scenarios (scripted telemetry) -------------------------------
def _signals(completed=0, queue_depth=0, qw95=0.0, dx50=0.0,
             fused_rows=0, padded_rows=0, fused_hist=None,
             max_queue_depth=0, stage_s=0.0, dispatch_s=0.0,
             rejected=0, exchange_s=0.0, compute_s=0.0):
    return {"completed": completed, "failed": 0,
            "queue_depth": queue_depth,
            "max_queue_depth": max_queue_depth,
            "queue_wait_p95": qw95, "device_execute_p50": dx50,
            "fused_rows": fused_rows, "padded_rows": padded_rows,
            "fused_hist": fused_hist or {}, "stage_s": stage_s,
            "dispatch_s": dispatch_s, "quarantines": 0,
            "rejected_queue_full": rejected,
            "exchange_s": exchange_s,
            "exchange_compute_s": compute_s,
            "latency_p99": 0.0}


def test_controller_queue_buildup_shrinks_window():
    cfg = ServeConfig()
    ctl = Controller(cfg)
    ctl.step(_signals(completed=1))  # baseline
    decisions = ctl.step(_signals(completed=10, qw95=0.050, dx50=0.002))
    moved = [d for d in decisions if d.knob == "batch_window"]
    assert len(moved) == 1
    assert moved[0].new == pytest.approx(0.0005)
    assert moved[0].new < moved[0].old
    assert "queue buildup" in moved[0].reason


def test_controller_window_decays_when_drained():
    cfg = ServeConfig()
    cfg.set("batch_window", 0.00025, source="test")
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    ctl.step(_signals(completed=10, qw95=0.0, dx50=0.010))
    assert cfg.batch_window == pytest.approx(0.0005)
    ctl.step(_signals(completed=20, qw95=0.0, dx50=0.010))
    assert cfg.batch_window == pytest.approx(0.001)  # back at default
    ctl.step(_signals(completed=30, qw95=0.0, dx50=0.010))
    assert cfg.batch_window == pytest.approx(0.001)  # never overshoots


def test_controller_pad_heavy_tightens_pin_policy():
    cfg = ServeConfig()
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    decisions = ctl.step(_signals(completed=10, qw95=0.001, dx50=0.002,
                                  fused_rows=10, padded_rows=6))
    moved = [d for d in decisions if d.knob == "pin_after"]
    assert len(moved) == 1 and moved[0].new == moved[0].old - 1
    ctl.step(_signals(completed=20, qw95=0.001, dx50=0.002,
                      fused_rows=20, padded_rows=6))
    assert cfg.pin_after == ServeConfig.default("pin_after")


def test_controller_max_batch_grows_on_full_bucket_backlog():
    cfg = ServeConfig()
    ctl = Controller(cfg)
    ctl.step(_signals(completed=1))
    decisions = ctl.step(_signals(
        completed=40, qw95=0.001, dx50=0.002,
        fused_hist={8: 5}, max_queue_depth=40))
    moved = [d for d in decisions if d.knob == "max_batch"]
    assert len(moved) == 1 and moved[0].new == 16


def test_controller_max_batch_shrinks_when_buckets_small():
    cfg = ServeConfig()
    cfg.set("max_batch", 32, source="test")
    ctl = Controller(cfg)
    ctl.step(_signals(completed=1))
    ctl.step(_signals(completed=10, qw95=0.001, dx50=0.002,
                      fused_hist={4: 6}))
    assert cfg.max_batch == 16


def test_controller_max_queue_grows_on_sustained_reject_burn():
    cfg = ServeConfig()
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    d1 = ctl.step(_signals(completed=5, queue_depth=10, rejected=4))
    assert not [d for d in d1 if d.knob == "max_queue"]
    assert cfg.max_queue == ServeConfig.default("max_queue")
    d2 = ctl.step(_signals(completed=9, queue_depth=12, rejected=11))
    moved = [d for d in d2 if d.knob == "max_queue"]
    assert len(moved) == 1
    assert moved[0].new == 2 * ServeConfig.default("max_queue")
    assert "queue-full burn" in moved[0].reason
    ctl.step(_signals(completed=12, queue_depth=12, rejected=15))
    ctl.step(_signals(completed=15, queue_depth=12, rejected=20))
    assert cfg.max_queue == 4 * ServeConfig.default("max_queue")
    lo, hi = ServeConfig.bounds("max_queue")
    assert lo <= cfg.max_queue <= hi


def test_controller_lease_ttl_widens_under_rtt_inflation():
    cfg = ServeConfig()
    default = ServeConfig.default("lease_ttl_ms")
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    s = _signals(completed=5)
    s["wire_rtt"] = 0.5                                   # > 0.2 * 1.5 s
    assert not [d for d in ctl.step(dict(s))
                if d.knob == "lease_ttl_ms"]
    assert cfg.lease_ttl_ms == default
    s["completed"] = 9
    moved = [d for d in ctl.step(dict(s)) if d.knob == "lease_ttl_ms"]
    assert len(moved) == 1 and moved[0].new == 2 * default
    assert "RTT" in moved[0].reason
    ctl.step(_signals(completed=9))
    assert cfg.lease_ttl_ms == default


def test_controller_max_queue_blip_then_quiet_never_moves():
    cfg = ServeConfig()
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    ctl.step(_signals(completed=5, queue_depth=4, rejected=2))   # blip
    ctl.step(_signals(completed=9, queue_depth=2, rejected=2))   # quiet
    ctl.step(_signals(completed=12, queue_depth=1, rejected=2))
    assert cfg.max_queue == ServeConfig.default("max_queue")
    assert not [d for d in ctl.decisions() if d.knob == "max_queue"]


def test_controller_max_queue_clamps_at_declared_bound():
    cfg = ServeConfig()
    _, hi = ServeConfig.bounds("max_queue")
    cfg.set("max_queue", hi, source="test")
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    ctl.step(_signals(completed=5, queue_depth=9, rejected=3))
    ctl.step(_signals(completed=9, queue_depth=9, rejected=9))
    assert cfg.max_queue == hi


def test_controller_max_queue_idle_decays_by_halving():
    cfg = ServeConfig()
    default = ServeConfig.default("max_queue")
    cfg.set("max_queue", 4 * default, source="test")
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=5))
    ctl.step(_signals(completed=5))
    assert cfg.max_queue == 2 * default
    ctl.step(_signals(completed=5))
    assert cfg.max_queue == default
    ctl.step(_signals(completed=5))
    assert cfg.max_queue == default


def test_controller_overlap_chunks_grows_on_sustained_exposed_exchange():
    cfg = ServeConfig()
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    d1 = ctl.step(_signals(completed=5, exchange_s=0.4, compute_s=0.2))
    assert not [d for d in d1 if d.knob == "overlap_chunks"]
    assert cfg.overlap_chunks == ServeConfig.default("overlap_chunks")
    d2 = ctl.step(_signals(completed=9, exchange_s=0.9, compute_s=0.4))
    moved = [d for d in d2 if d.knob == "overlap_chunks"]
    assert len(moved) == 1
    assert moved[0].new == 2 * ServeConfig.default("overlap_chunks")
    assert "exchange rivals compute" in moved[0].reason
    ctl.step(_signals(completed=12, exchange_s=1.5, compute_s=0.6))
    ctl.step(_signals(completed=15, exchange_s=2.2, compute_s=0.8))
    assert cfg.overlap_chunks == 4 * ServeConfig.default("overlap_chunks")
    lo, hi = ServeConfig.bounds("overlap_chunks")
    assert lo <= cfg.overlap_chunks <= hi


def test_controller_overlap_chunks_decays_when_exchange_hidden():
    cfg = ServeConfig()
    cfg.set("overlap_chunks", 8, source="test")
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    ctl.step(_signals(completed=5, exchange_s=0.02, compute_s=0.5))
    assert cfg.overlap_chunks == 4
    ctl.step(_signals(completed=9, exchange_s=0.04, compute_s=1.0))
    assert cfg.overlap_chunks == 2
    ctl.step(_signals(completed=12))
    assert cfg.overlap_chunks == 2
    ctl.step(_signals(completed=15, exchange_s=0.06, compute_s=1.5))
    assert cfg.overlap_chunks == ServeConfig.default("overlap_chunks")
    ctl.step(_signals(completed=18, exchange_s=0.08, compute_s=2.0))
    assert cfg.overlap_chunks == ServeConfig.default("overlap_chunks")


def test_controller_overlap_chunks_streak_broken_by_local_step():
    cfg = ServeConfig()
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    ctl.step(_signals(completed=5, exchange_s=0.4, compute_s=0.2))
    ctl.step(_signals(completed=9))                      # local only
    ctl.step(_signals(completed=12, exchange_s=0.8, compute_s=0.4))
    assert cfg.overlap_chunks == ServeConfig.default("overlap_chunks")
    assert not [d for d in ctl.decisions() if d.knob == "overlap_chunks"]


def test_controller_overlap_chunks_idle_decays_by_halving():
    cfg = ServeConfig()
    cfg.set("overlap_chunks", 4, source="test")
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=5))
    ctl.step(_signals(completed=5))
    assert cfg.overlap_chunks == 2
    ctl.step(_signals(completed=5))
    assert cfg.overlap_chunks == ServeConfig.default("overlap_chunks")
    ctl.step(_signals(completed=5))
    assert cfg.overlap_chunks == ServeConfig.default("overlap_chunks")


def test_metrics_record_exchange_overlap_feeds_signals():
    m = ServeMetrics()
    m.record_exchange_overlap(0.25, 0.75)
    m.record_exchange_overlap(0.05, 0.10)
    s = m.signals()
    assert s["exchange_s"] == pytest.approx(0.30)
    assert s["exchange_compute_s"] == pytest.approx(0.85)


def test_controller_idle_decays_managed_knobs_to_defaults():
    cfg = ServeConfig()
    cfg.update({"batch_window": 0.000125, "pin_after": 1,
                "max_batch": 16}, source="test")
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=5))
    for _ in range(8):
        ctl.step(_signals(completed=5))
    assert cfg.batch_window == pytest.approx(
        ServeConfig.default("batch_window"))
    assert cfg.pin_after == ServeConfig.default("pin_after")
    assert cfg.max_batch == ServeConfig.default("max_batch")


def test_controller_hysteresis_dead_band():
    cfg = ServeConfig()
    ctl = Controller(cfg, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    for k in range(5):
        decisions = ctl.step(_signals(completed=10 + k, qw95=0.002,
                                      dx50=0.002))
        assert decisions == []
    assert cfg.batch_window == ServeConfig.default("batch_window")


def test_controller_cooldown_blocks_oscillation():
    cfg = ServeConfig()
    ctl = Controller(cfg, cooldown_steps=3)
    ctl.step(_signals(completed=1))
    ctl.step(_signals(completed=10, qw95=0.050, dx50=0.002))
    assert cfg.batch_window == pytest.approx(0.0005)
    changed_at = cfg.batch_window
    for k in range(3):
        decisions = ctl.step(_signals(completed=20 + k, qw95=0.0,
                                      dx50=0.010))
        assert all(d.knob != "batch_window" for d in decisions)
        assert cfg.batch_window == changed_at
    ctl.step(_signals(completed=40, qw95=0.0, dx50=0.010))
    assert cfg.batch_window > changed_at


def test_controller_pipeline_depth_rule_uses_executor_auto():
    reg, sig, plan = _registry()
    ex = ServeExecutor(reg, autostart=False)
    cfg = ex.config
    ctl = Controller(cfg, executor=ex, cooldown_steps=0)
    ctl.step(_signals(completed=1))
    auto = ex._pipeline_slots()
    ctl.step(_signals(completed=10, qw95=0.001, dx50=0.002,
                      stage_s=0.6, dispatch_s=1.0))
    assert cfg.pipeline_depth == auto + 1
    ctl.step(_signals(completed=20, qw95=0.001, dx50=0.002,
                      stage_s=0.6, dispatch_s=11.0))
    assert cfg.pipeline_depth in (0, auto)
    ex.close()


class _CardPlan:
    """A registered plan that says it lives on the card (what the auto
    depth reads), without touching one."""
    device = torch.device("cuda", 0)

    def estimated_device_bytes(self):
        return 0


@pytest.mark.parametrize("pool", [None, 2])
def test_auto_pipeline_depth_before_the_first_bucket(pool):
    """The depth the controller reads before any bucket is the one the
    dispatcher will use: pool + 1 for plans on the card (decided from
    the pool or the registry's plans), the pool alone on the host — the
    JAX executor's number on its CPU backend."""
    from spfft_tpu.serve import PlanRegistry as JRegistry
    from spfft_tpu.serve import ServeExecutor as JExecutor
    reg, sig, plan = _registry()
    devices = ["cpu"] * pool if pool else None
    with ServeExecutor(reg, autostart=False, devices=devices) as ex:
        jex = JExecutor(JRegistry(), autostart=False,
                        devices=(__import__("jax").devices()[:pool]
                                 if pool else None))
        try:
            assert ex._pipeline_slots() == jex._pipeline_slots() \
                == (pool or 1)
        finally:
            jex.close()
    card = PlanRegistry(store=False)
    card.put(sig, _CardPlan())
    cdevices = ["cuda:0"] * pool if pool else None
    ex = ServeExecutor(card, autostart=False, devices=cdevices)
    try:
        assert ex._pipeline_slots() == (pool or 1) + 1
        ctl = Controller(ex.config, executor=ex, cooldown_steps=0)
        ctl.step(_signals(completed=1))
        ctl.step(_signals(completed=10, stage_s=0.6, dispatch_s=1.0))
        assert ex.config.pipeline_depth == (pool or 1) + 2
    finally:
        ex.close()


def test_controller_fuzz_knobs_never_leave_bounds():
    cfg = ServeConfig()
    ctl = Controller(cfg, cooldown_steps=0)
    errors = []

    def check_bounds():
        for name, value in cfg.snapshot().items():
            lo, hi = ServeConfig.bounds(name)
            if not lo <= value <= hi:
                errors.append(f"{name}={value} outside [{lo}, {hi}]")

    def hammer(seed):
        rng = np.random.default_rng(seed)
        knobs = list(KNOB_SPECS)
        try:
            for _ in range(200):
                name = knobs[int(rng.integers(len(knobs)))]
                cfg.set(name, float(rng.uniform(-1e9, 1e9)),
                        source=f"fuzz{seed}")
                check_bounds()
        except Exception as exc:  # pragma: no cover
            errors.append(repr(exc))

    def steer(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in range(100):
                ctl.step(_signals(
                    completed=i * 3,
                    qw95=float(rng.uniform(0, 0.1)),
                    dx50=float(rng.uniform(0, 0.01)),
                    fused_rows=i * 8,
                    padded_rows=int(rng.integers(0, i * 4 + 1)),
                    fused_hist={8: i},
                    max_queue_depth=int(rng.integers(0, 100))))
                check_bounds()
        except Exception as exc:  # pragma: no cover
            errors.append(repr(exc))

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(6)]
    threads += [threading.Thread(target=steer, args=(s,)) for s in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    check_bounds()
    assert errors == []


def test_mid_stream_retune_is_bit_exact():
    """Results while a thread retunes window / max_batch / pin_after /
    pipeline_depth mid-stream equal each request's serial execution bit
    for bit: a retune changes neither a bucket already staged nor a
    buffer in flight."""
    reg, sig, plan = _registry()
    rng = np.random.default_rng(11)
    vals = [_values(plan, rng) for _ in range(60)]
    oracles = [plan.backward(v) for v in vals]
    ex = ServeExecutor(reg, batch_window=0.0005, max_batch=8)
    stop = threading.Event()

    def retuner():
        flip = 0
        while not stop.is_set():
            ex.config.set("batch_window", 0.0 if flip % 2 else 0.002,
                          source="test")
            ex.config.set("max_batch", 4 if flip % 3 else 8, source="test")
            ex.config.set("pin_after", 1 + flip % 3, source="test")
            ex.config.set("pipeline_depth", flip % 3, source="test")
            flip += 1
            time.sleep(0.001)

    t = threading.Thread(target=retuner)
    t.start()
    try:
        futures = [ex.submit(sig, v) for v in vals]
        results = [f.result(timeout=60) for f in futures]
    finally:
        stop.set()
        t.join()
        ex.close()
    for i, (got, want) in enumerate(zip(results, oracles)):
        assert torch.equal(got, want), f"request {i} diverged"
    lo, hi = ServeConfig.bounds("batch_window")
    assert lo <= ex.config.batch_window <= hi


def test_control_loop_steps_and_stops():
    ctl = Controller(ServeConfig(), metrics=ServeMetrics())
    with ControlLoop(ctl, interval=0.005):
        time.sleep(0.05)
    steps = ctl.steps
    assert steps >= 2
    time.sleep(0.02)
    assert ctl.steps == steps


# -- the differential against the JAX controller ----------------------------
STRETCHES = ("idle", "backlog", "drained", "pad", "reject", "exchange",
             "hidden", "spmd", "rtt", "staging")


def _sequence(seed, steps=200):
    """A seeded signal sequence of stretches, cumulative counters as
    ``ServeMetrics.signals()`` / ``SPMDCoalescer.signals()`` carry them."""
    rng = np.random.default_rng(seed)
    c = {"completed": 0, "failed": 0, "fused_rows": 0, "padded_rows": 0,
         "stage_s": 0.0, "dispatch_s": 0.0, "rejected_queue_full": 0,
         "exchange_s": 0.0, "exchange_compute_s": 0.0, "spmd_launches": 0,
         "spmd_coalesced": 0, "quarantines": 0}
    fused_hist, spmd_hist = {}, {}
    out = []
    kind, left = "idle", 0
    for _ in range(steps):
        if left == 0:
            kind = STRETCHES[int(rng.integers(len(STRETCHES)))]
            left = int(rng.integers(3, 15))
        left -= 1
        s = {"queue_depth": 0, "max_queue_depth": 0, "queue_wait_p95": 0.0,
             "device_execute_p50": float(rng.uniform(0.001, 0.01)),
             "latency_p99": float(rng.uniform(0.001, 0.05)),
             "spmd_queue_depth": 0, "spmd_launch_p50": 0.0, "wire_rtt": 0.0}
        if kind != "idle":
            c["completed"] += int(rng.integers(1, 20))
            s["queue_depth"] = int(rng.integers(0, 6))
        if kind == "backlog":
            mb = int(rng.choice([4, 8, 16, 32]))
            fused_hist[mb] = fused_hist.get(mb, 0) + int(rng.integers(2, 6))
            c["fused_rows"] += 8 * mb
            s["max_queue_depth"] = int(rng.integers(10, 200))
            s["queue_wait_p95"] = float(rng.uniform(0.02, 0.2))
        elif kind == "drained":
            b = int(rng.integers(1, 4))
            fused_hist[b] = fused_hist.get(b, 0) + 1
            c["fused_rows"] += b
        elif kind == "pad":
            rows = int(rng.integers(4, 40))
            c["fused_rows"] += rows
            c["padded_rows"] += int(rng.integers(0, rows))
        elif kind == "reject":
            c["rejected_queue_full"] += int(rng.integers(0, 5))
            s["queue_depth"] = int(rng.integers(5, 50))
        elif kind in ("exchange", "hidden"):
            ex, cp = float(rng.uniform(0.01, 0.5)), float(rng.uniform(0.01,
                                                                      0.5))
            if kind == "hidden":
                ex *= 0.05
            c["exchange_s"] += ex
            c["exchange_compute_s"] += cp
        elif kind == "spmd":
            c["spmd_launches"] += int(rng.integers(0, 4))
            c["spmd_coalesced"] += int(rng.integers(0, 3)) * 2
            s["spmd_queue_depth"] = int(rng.integers(0, 6))
            s["spmd_launch_p50"] = float(rng.uniform(0.0, 0.02))
            size = int(rng.choice([1, 2, 8, 16]))
            spmd_hist[size] = spmd_hist.get(size, 0) + int(rng.integers(1, 4))
        elif kind == "rtt":
            s["wire_rtt"] = float(rng.uniform(0.0, 1.5))
        elif kind == "staging":
            c["dispatch_s"] += float(rng.uniform(0.01, 0.2))
            c["stage_s"] += float(rng.uniform(0.0, 0.2))
        s.update(c)
        s["fused_hist"] = dict(fused_hist)
        s["spmd_batch_hist"] = dict(spmd_hist)
        out.append(s)
    return out


class _AutoDepth:
    """The executor's one seam the depth rule reads."""

    def __init__(self, slots):
        self.slots = slots

    def _pipeline_slots(self):
        return self.slots


@pytest.mark.parametrize("seed", range(6))
def test_controller_decisions_equal_jax(seed):
    seq = _sequence(seed)
    runs = []
    for mod in (control, jcontrol):
        cfg = mod.ServeConfig()
        ctl = mod.Controller(cfg, executor=_AutoDepth(1 + seed % 2),
                             cooldown_steps=seed % 4)
        for s in copy.deepcopy(seq):
            ctl.step(s)
        runs.append(([(d.step, d.knob, d.old, d.new, d.reason)
                      for d in ctl.decisions()], cfg.snapshot(), ctl.steps))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) >= 10  # the stretches move knobs
    moved = {d[1] for d in runs[0][0]}
    assert len(moved) >= 5, moved


SLO_FORMS = ["p99_ms=50,error_rate=0.01,max_quarantines=0", "p99_s=2",
             "latency_p99_ms=7", "latency_p99_s=0.5, error_rate=0.2",
             " ,p99_ms=3,", "max_quarantines=4", "", "p99_ms", "p99_ms=abc",
             "uptime=0.999", "error_rate=-1", "p99_ms=nan"]


@pytest.mark.parametrize("form", SLO_FORMS)
def test_slo_spec_parse_equals_jax(form, tmp_path):
    def parse(mod, err):
        try:
            return ("ok", mod.SLOSpec.parse(form).declared())
        except err as exc:
            return ("error", str(exc))
    assert parse(control, InvalidParameterError) == \
        parse(jcontrol, JInvalid)
    f = tmp_path / "slo.json"
    f.write_text(json.dumps({"latency_p99_s": 0.1, "error_rate": 0.5}))
    assert SLOSpec.parse(f"@{f}").declared() == \
        jcontrol.SLOSpec.parse(f"@{f}").declared()
    f.write_text(json.dumps({"bogus": 1}))
    with pytest.raises(InvalidParameterError):
        SLOSpec.parse(f"@{f}")


@pytest.mark.parametrize("seed", range(5))
def test_slo_watchdog_verdicts_equal_jax(seed):
    rng = np.random.default_rng(100 + seed)
    spec = dict(latency_p99_s=0.010, error_rate=0.05,
                max_quarantines=float(seed % 2))
    dogs = [mod.SLOWatchdog(None, mod.SLOSpec(**spec), fast_window=3,
                            slow_window=9)
            for mod in (control, jcontrol)]
    completed = failed = quarantines = 0
    for _ in range(200):
        burning = rng.random() < 0.4
        completed += int(rng.integers(0, 20))
        failed += int(rng.integers(0, 3)) if burning else 0
        quarantines += int(rng.random() < 0.05)
        sig = {"completed": completed, "failed": failed,
               "quarantines": quarantines,
               "latency_p99": float(rng.uniform(0.0, 0.05 if burning
                                                else 0.009))}
        verdicts = [dog.evaluate(dict(sig)) for dog in dogs]
        assert verdicts[0] == verdicts[1]
    for name in spec:
        assert obs.GLOBAL_COUNTERS.get("spfft_slo_window_alerts_total",
                                       slo=name) == \
            jobs.GLOBAL_COUNTERS.get("spfft_slo_window_alerts_total",
                                     slo=name)


# -- SLO watchdog scenarios --------------------------------------------------
def test_slo_watchdog_violation_degrades_health_and_recovers():
    metrics = ServeMetrics()
    for _ in range(20):
        metrics.record_request_done(0.200)
    dog = SLOWatchdog(metrics, SLOSpec(latency_p99_s=0.050))
    verdict = dog.evaluate()
    assert verdict["violations"] == ["latency_p99_s"]
    assert verdict["burn"]["latency_p99_s"] == pytest.approx(4.0)
    health = metrics.health()
    assert health["state"] == "degraded"
    assert health["lifecycle_state"] == "healthy"
    assert health["slo_violations"] == ["latency_p99_s"]
    assert obs.GLOBAL_COUNTERS.get("spfft_slo_violation",
                                   slo="latency_p99_s") == 1
    for _ in range(metrics._window):
        metrics.record_request_done(0.001)
    assert dog.evaluate()["violations"] == []
    assert metrics.health()["state"] == "healthy"


def test_slo_zero_objective_and_lifecycle():
    metrics = ServeMetrics()
    metrics.record_request_done(0.001)
    metrics.record_quarantine()
    verdict = SLOWatchdog(metrics, SLOSpec(max_quarantines=0)).evaluate()
    assert verdict["violations"] == ["max_quarantines"]
    assert verdict["burn"]["max_quarantines"] == float("inf")
    failed = ServeMetrics()
    failed.record_health("failed")
    failed.record_slo(["error_rate"])
    assert failed.health()["state"] == "failed"
    with pytest.raises(InvalidParameterError):
        SLOWatchdog(None, SLOSpec(latency_p99_s=0.01), fast_window=0)
    with pytest.raises(InvalidParameterError):
        SLOWatchdog(None, SLOSpec(latency_p99_s=0.01), fast_window=10,
                    slow_window=5)


# -- the tuner and the CLI ----------------------------------------------------
def _cell(w, mb, tp, p99):
    return {"batch_window_ms": w, "max_batch": mb,
            "result": tp and {"throughput_rps": tp,
                              "serve_metrics": {"latency_seconds":
                                                {"p99": p99}}}}


@pytest.mark.parametrize("slack", [0.0, 0.05, 0.5])
def test_score_grid_equals_jax(slack):
    rng = np.random.default_rng(7)
    grids = [[], [_cell(0.0, 8, None, None)]]
    for _ in range(20):
        grids.append([_cell(float(w), int(mb),
                            float(rng.uniform(50, 100)),
                            float(rng.uniform(0.001, 0.1)))
                      if rng.random() > 0.1 else _cell(w, mb, None, None)
                      for w in (0.0, 0.5, 1.0, 2.0) for mb in (4, 8, 16)])
    for cells in grids:
        assert tuner._score_grid(copy.deepcopy(cells), slack) == \
            jtuner._score_grid(copy.deepcopy(cells), slack)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def test_cli_show_and_check_equal_jax(tmp_path, capsys):
    assert cli.main(["show", "--json"]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["show", "--json"]) == 0
    jax_out = capsys.readouterr().out
    assert port == jax_out
    cfg = ServeConfig()
    cfg.set("batch_window", 0.004, source="tuner")
    cfg.set("max_batch", 999999, source="tuner")  # clamped
    path = tmp_path / "recommended.json"
    cfg.save(str(path), provenance={"protocol": "test"})
    assert cli.main(["check", str(path)]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["check", str(path)]) == 0
    assert port == capsys.readouterr().out
    assert _json_lines(port)[-1]["ok"]
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert cli.main(["check", str(bad)]) == 1 == jcli.main(["check",
                                                            str(bad)])


def test_cli_tune_quick_on_the_host(tmp_path, capsys):
    """``tune --quick --cpu``: two cells of the port's serve.bench, the
    artifact ``check`` accepts and ``serve.bench --config`` boots."""
    out = tmp_path / "tuned.json"
    assert cli.main(["tune", "--quick", "--cpu", "--dim", "12",
                     "--requests", "8", "--threads", "2", "-o",
                     str(out)]) == 0
    payload = _json_lines(capsys.readouterr().out)[-1]
    artifact = json.loads(out.read_text())
    assert len(artifact["provenance"]["grid"]) == 2
    assert all(c["result"] for c in artifact["provenance"]["grid"])
    assert artifact["provenance"]["platform"]["backend"] == "cpu"
    assert payload["best"] == artifact["provenance"]["best"]
    assert cli.main(["check", str(out)]) == 0
    assert jcli.main(["check", str(out)]) == 0  # the JAX package reads it
    capsys.readouterr()
    from spfft_tpu_torch.serve.bench import main as bench
    assert bench(["--cpu", "--dim", "12", "--requests", "4", "--threads",
                  "1", "--config", str(out)]) == 0
    best = artifact["provenance"]["best"]
    text = capsys.readouterr().out
    assert f"window={best['batch_window_ms']:.1f}ms" in text
    assert f"max_batch={best['max_batch']}" in text


def test_cli_tune_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli.main(["tune", "--quick"]) == 1
    assert "DeviceError" in capsys.readouterr().err


def test_control_loop_thread_never_touches_the_card(monkeypatch):
    """The loop's thread reads host counters only: a live replay under a
    fast loop makes no synchronize or stream call from that thread."""
    calls = []

    def spy(name):
        def f(*a, **kw):
            if threading.current_thread().name == "spfft-control-loop":
                calls.append(name)
        return f
    for name in ("synchronize", "current_stream", "default_stream",
                 "stream", "set_stream"):
        monkeypatch.setattr(torch.cuda, name, spy(name))
    reg, sig, plan = _registry()
    rng = np.random.default_rng(5)
    with ServeExecutor(reg, batch_window=0.0005) as ex:
        ctl = Controller(ex.config, metrics=ex.metrics, executor=ex,
                         cooldown_steps=0)
        with ControlLoop(ctl, interval=0.001):
            futs = [ex.submit(sig, _values(plan, rng)) for _ in range(40)]
            for f in futs:
                f.result(timeout=60)
            time.sleep(0.02)
    assert ctl.steps >= 2
    assert calls == []
