"""The port's seeded chaos harness (``python -m spfft_tpu_torch.serve.bench
--chaos SEED``) on the CPU against the JAX package's.

Both harnesses draw every storm from one ``numpy`` generator seeded
alike, over the same fault sites, so seed 7 must give the same phases,
the same storms (scripts, served and typed-failure counts), the same
fault sites fired as often and the same subsystems; each run must pass
its own invariants (no hang, typed failures only, healthy requests bit
for bit, zero open spans, no torn artifact) and the coverage floors the
JAX CLI test restates.
"""

import json

import pytest
import torch

from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg
from spfft_tpu.serve.bench import main as jmain

from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.serve.bench import main

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for f, o, c in ((faults, obs, tcfg), (jfaults, jobs, jcfg)):
            f.disarm()
            o.disable()
            o.GLOBAL_TRACER.reset()
            o.GLOBAL_COUNTERS.reset()
            o.reset_recorder()
            c.set_global_config(None)
    reset()
    yield
    reset()


def _last_json(capsys):
    out = capsys.readouterr().out
    line = next(ln for ln in reversed(out.splitlines())
                if ln.startswith("{"))
    return json.loads(line), out


def test_chaos_seed_7_equals_jax(capsys):
    try:
        rc = main(["--cpu", "--chaos", "7"])
    finally:
        faults.disarm()
    payload, text = _last_json(capsys)
    assert rc == 0, payload["failures"]
    assert payload["chaos"] and payload["ok"]
    assert payload["failures"] == []
    assert payload["seed"] == 7
    assert payload["phases"]["G_flight_recorder"]["bundles"] >= 1
    assert len(payload["fired_sites"]) >= 8
    assert len(payload["subsystems"]) >= 4
    assert "chaos" in text
    try:
        assert jmain(["--chaos", "7"]) == 0
    finally:
        jfaults.disarm()
    jax_payload, _ = _last_json(capsys)
    assert set(payload) == set(jax_payload)
    assert list(payload["phases"]) == list(jax_payload["phases"])
    assert payload["fired_sites"] == jax_payload["fired_sites"]
    assert payload["subsystems"] == jax_payload["subsystems"]
    assert payload["storms"] == jax_payload["storms"]
    assert payload["phases"]["A_fused_demotion"].keys() == \
        jax_payload["phases"]["A_fused_demotion"].keys() == {"dec"}
    for phase in ("D_pod_lane_death", "D2_spmd_window_fault",
                  "E_wire_blob_storms"):
        assert payload["phases"][phase] == jax_payload["phases"][phase]


def test_chaos_other_seed_passes(capsys):
    try:
        rc = main(["--cpu", "--chaos", "11"])
    finally:
        faults.disarm()
    payload, _ = _last_json(capsys)
    assert rc == 0, payload["failures"]
    assert payload["ok"] and len(payload["fired_sites"]) >= 23
