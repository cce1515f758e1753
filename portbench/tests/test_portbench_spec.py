"""Every cell of BENCHMARK.json resolves to the files the harness finds
by name, and the file keeps to the benchmark's contract's shapes."""

import json
import re

import pytest

from portbench_support import ROOT
from portbench import spec
from portbench.traffic import KEYS

BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.Cell(BENCH, cell)
    assert c.config["name"] == c.workload["config"]
    assert c.config_path.is_file() and c.traffic_path.is_file()
    assert set(KEYS) == set(c.traffic_params)
    api = c.caller()
    assert c.caller_path.is_file() and callable(api.call)
    assert api.handles(8) in (1, 8)
    assert {m["name"] for m in c.end_to_end} == {
        "pairs_per_s", "call_p95_ms", "setup_s"}
    assert len(c.per_layer) == 8
    readers = c.readers()
    assert set(readers) == {m["name"] for m in c.per_layer}
    assert all(callable(r) for r in readers.values())
    for k in ("band_rel_l2", "value_err_rms"):
        assert c.config["limits"][k] is not None


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for entry in BENCH["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("portbench/")
        assert json.loads((ROOT / entry["file"]).read_text())["name"] \
            == entry["name"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["name"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], m["layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024
