"""Helpers of the benchmark's tests: the configurations at small
sizes."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def small_config(name: str, n: int = 16, bands: int = 16,
                 sparsity: float = None) -> dict:
    """The configuration ``name`` at an n^3 grid, ``bands`` resident
    bands, and its own sparsity unless ``sparsity`` is given; its limits
    kept."""
    cfg = copy.deepcopy(load_config(name))
    cfg.update(dims=[n, n, n], bands=bands)
    if sparsity is not None:
        cfg["sparsity"] = sparsity
    return cfg
