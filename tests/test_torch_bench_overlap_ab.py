"""``scripts/torch_bench_overlap_ab.py`` (the tuner's overlap stage in the
port) on the CPU: its payload carries the JAX script's keys, row for row,
its K = 1 rows are the plans' without chunks bit for bit (the script
exits 1 otherwise, and a broken exchange makes it do so), and it reports
no overlap for shards that share one device."""

import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARGS = ["--shards", "2", "--dim", "12", "--reps", "1", "--rounds", "1",
        "--chunks", "1", "2"]


def test_payload_keys_equal_jax(tmp_path):
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    assert _script("torch_bench_overlap_ab").main(
        ARGS + ["--cpu", "-o", str(port_out)]) == 0
    assert _script("bench_overlap_ab").main(ARGS + ["-o", str(jax_out)]) \
        == 0
    port, jax = json.loads(port_out.read_text()), \
        json.loads(jax_out.read_text())
    assert set(port) == set(jax)
    assert [set(r) for r in port["rows"]] == [set(r) for r in jax["rows"]]
    assert [(r["label"], r["exchange"], r["k"]) for r in port["rows"]] == \
        [(r["label"], r["exchange"], r["k"]) for r in jax["rows"]]
    assert port["num_values"] == jax["num_values"]
    assert port["backend"] == "cpu" and port["overlap_meaningful"] is False
    assert all(r["async_starts"] == 0 for r in port["rows"])
    assert [r["collectives_bwd"] for r in port["rows"]] == [1, 2, 1, 2]
    assert all(r["vs_k1"] == 1.0 for r in port["rows"] if r["k"] == 1)


def test_chunked_rows_must_match_the_plain_plan(monkeypatch, capsys):
    """The script's bit-for-bit check has teeth: a chunked plan whose
    round trip drifts by one ulp makes it exit 1."""
    from spfft_tpu_torch.parallel import dist
    orig = dist.DistributedTransformPlan.apply_pointwise

    def drift(self, values, *a, **kw):
        out = orig(self, values, *a, **kw)
        return out if self.overlap_chunks == 1 else \
            torch.nextafter(out, out + 1)
    monkeypatch.setattr(dist.DistributedTransformPlan, "apply_pointwise",
                        drift)
    assert _script("torch_bench_overlap_ab").main(ARGS + ["--cpu"]) == 1
    assert "differs from the plan's without chunks" in \
        capsys.readouterr().err


def test_tuner_overlap_stage_recommends_one_chunk(monkeypatch):
    from types import SimpleNamespace

    from spfft_tpu_torch.control import tuner
    out = tuner._tune_overlap(SimpleNamespace(overlap_dim=12, cpu=True))
    assert out["recommended_k"] == 1 and out["overlap_meaningful"] is False
    assert out["backend"] == "cpu" and len(out["rows"]) == 6


@pytest.mark.parametrize("flag", [[], ["--cpu"]])
def test_without_a_card(flag, capsys):
    if torch.cuda.is_available() or flag:
        assert _script("torch_bench_overlap_ab").main(
            ["--shards", "2", "--dim", "8", "--reps", "1", "--rounds", "1",
             "--chunks", "1"] + flag) == 0
    else:
        assert _script("torch_bench_overlap_ab").main(["--dim", "8"]) == 1
        assert "DeviceError" in capsys.readouterr().err
