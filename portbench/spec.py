"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json``, the traffic's caller in
``callers/<api>.py``, each per-layer metric's reader in
``metrics/<name>.py``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with what it names resolved."""

    def __init__(self, bench: dict, name: str, here: Path = HERE):
        self.workload = find(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.workload["chips"])
        entry = find(bench["configs"], self.workload["config"], "config")
        self.config_path = Path(here).parent / entry["file"]
        self.config = json.loads(self.config_path.read_text())
        self.traffic_path = Path(here) / "traffic" / \
            f"{self.workload['traffic']}.json"
        self.traffic_params = json.loads(self.traffic_path.read_text())
        self.caller_path = Path(here) / "callers" / \
            f"{self.traffic_params['api']}.py"
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.metric_paths = {m["name"]: Path(here) / "metrics" /
                             f"{m['name']}.py" for m in self.per_layer}

    def readers(self) -> dict:
        """``{metric name: read function}`` of the cell's per-layer
        metrics, each loaded from its own file."""
        return {name: _load(f"portbench.metrics.{name}", path).read
                for name, path in self.metric_paths.items()}

    def caller(self):
        """The module of the traffic's caller (``handles``, ``call``)."""
        return _load(f"portbench.callers.{self.traffic_params['api']}",
                     self.caller_path)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
