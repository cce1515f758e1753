"""The port's remote artifact tier (``spfft_tpu_torch.net.blobstore``) and
the store's use of it, on the CPU.

* ``FileBlobStore`` and the loopback HTTP store (``serve_blobstore`` on
  127.0.0.1, port 0): get / put / list / stat / delete, typed misses and
  errors, and the byte and wire format of the JAX package's module — each
  package's client reads what the other's server or directory holds;
* ``gc_blobstore`` sweeps one namespace (the port's ``torch/req/``) and
  leaves the JAX package's ``req/`` as it was;
* the store's remote tier: a spill publishes under ``torch/art/`` and
  ``torch/req/``, a fresh store over another directory boots warm from
  the remote alone (``builds == 0``, written through to its disk), a
  remote failure degrades to a counted miss;
* ``python -m spfft_tpu_torch.net.blobstore --serve ROOT`` serves.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.net import blobstore as jblob

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.errors import BlobStoreError, InvalidParameterError
from spfft_tpu_torch.net import blobstore as tblob
from spfft_tpu_torch.serve import PlanRegistry
from spfft_tpu_torch.serve import store as tstore
from spfft_tpu_torch.utils.workloads import spherical_cutoff_triplets

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 12


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(tstore.BLOB_STORE_ENV, raising=False)
    for f, o in ((faults, obs), (jfaults, jobs)):
        f.disarm()
        o.GLOBAL_COUNTERS.reset()
    yield
    faults.disarm()


@pytest.fixture
def http_store(tmp_path):
    server, thread = tblob.serve_blobstore(str(tmp_path / "served"))
    yield f"http://127.0.0.1:{server.server_port}", tmp_path / "served"
    server.shutdown()
    server.server_close()
    thread.join(10)


def _exercise(store):
    assert store.get("art/missing.plan") is None
    store.put("torch/art/a.plan", b"\x00abc")
    store.put("torch/req/r.json", b"{}")
    assert store.get("torch/art/a.plan") == b"\x00abc"
    assert store.list() == ["torch/art/a.plan", "torch/req/r.json"]
    st = store.stat("torch/art/a.plan")
    assert st["size"] == 4 and st["mtime"] > 0
    assert store.stat("nope") is None
    assert store.delete("torch/req/r.json") is True
    assert store.delete("torch/req/r.json") is False
    for bad in ("", "/abs", "../up", "a/../b", ".hidden"):
        with pytest.raises(InvalidParameterError):
            store.get(bad)


def test_file_blobstore_and_the_jax_directory_format(tmp_path):
    root = str(tmp_path / "blobs")
    _exercise(tblob.FileBlobStore(root))
    # the JAX package's store reads and writes the same bytes in place
    jb = jblob.FileBlobStore(root)
    assert jb.get("torch/art/a.plan") == b"\x00abc"
    jb.put("req/j.json", b"[1]")
    assert tblob.FileBlobStore(root).get("req/j.json") == b"[1]"
    snap = obs.GLOBAL_COUNTERS.snapshot()["spfft_blob_ops_total"]
    assert sum(snap["samples"].values()) >= 3


def test_http_blobstore_loopback_and_the_jax_wire(http_store):
    url, root = http_store
    _exercise(tblob.HttpBlobStore(url))
    # the JAX package's client against this package's server
    jc = jblob.HttpBlobStore(url)
    assert jc.get("torch/art/a.plan") == b"\x00abc"
    jc.put("req/x.json", b"x")
    assert sorted(jc.list()) == ["req/x.json", "torch/art/a.plan"]
    assert jc.stat("req/x.json")["size"] == 1
    # and this package's client against the JAX package's server
    server, thread = jblob.serve_blobstore(str(root))
    try:
        tc = tblob.HttpBlobStore(f"http://127.0.0.1:{server.server_port}")
        assert tc.get("req/x.json") == b"x"
        assert tc.delete("req/x.json") and tc.get("req/x.json") is None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def test_open_blobstore_and_typed_failures(tmp_path):
    assert tblob.open_blobstore("") is None
    assert isinstance(tblob.open_blobstore(str(tmp_path / "d")),
                      tblob.FileBlobStore)
    assert isinstance(tblob.open_blobstore("http://127.0.0.1:9"),
                      tblob.HttpBlobStore)
    with pytest.raises(InvalidParameterError):
        tblob.HttpBlobStore("ftp://x")
    store = tblob.FileBlobStore(str(tmp_path / "d"))
    faults.arm(faults.FaultPlan(script="blob.get@1,blob.put@1"))
    with pytest.raises(BlobStoreError):
        store.get("torch/art/a.plan")
    with pytest.raises(BlobStoreError):
        store.put("torch/art/a.plan", b"x")
    # nothing listens on the discard port: an OSError, typed
    with pytest.raises(BlobStoreError):
        tblob.HttpBlobStore("http://127.0.0.1:9", timeout=2).get("a")


def test_gc_blobstore_sweeps_only_its_namespace(tmp_path):
    root = str(tmp_path / "b")
    store = tblob.FileBlobStore(root)
    for i in range(4):
        store.put(f"torch/req/{i}.json", b"x" * 100)
        os.utime(os.path.join(root, "torch", "req", f"{i}.json"),
                 (1000 + i, 1000 + i))
        store.put(f"req/{i}.json", b"y" * 100)
    out = tblob.gc_blobstore(store, 250)
    assert out["removed"] == ["torch/req/0.json", "torch/req/1.json"]
    assert out["bytes_in_use"] == 200 and out["errors"] == 0
    assert [k for k in store.list() if k.startswith("req/")] == \
        [f"req/{i}.json" for i in range(4)]
    assert tblob.gc_blobstore(store, 0)["removed"] == []


def _build(store):
    reg = PlanRegistry(store=store)
    tr = spherical_cutoff_triplets(DIM)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM, tr,
                                 device="cpu")
    store.drain()
    return reg, tr, sig, plan


@pytest.mark.parametrize("kind", ["file", "http"])
def test_store_remote_tier_boots_a_fresh_disk_warm(tmp_path, kind,
                                                   http_store):
    remote = str(tmp_path / "remote") if kind == "file" else http_store[0]
    a = tstore.PlanArtifactStore(str(tmp_path / "a"), remote=remote,
                                 plan_kwargs={"device": "cpu"})
    _, tr, sig, plan = _build(a)
    keys = tblob.open_blobstore(remote).list()
    key = tstore.signature_key(sig)
    assert f"torch/art/{key}.plan" in keys
    assert any(k.startswith("torch/req/") for k in keys)
    assert not any(k.startswith(("art/", "req/")) for k in keys)
    b = tstore.PlanArtifactStore(str(tmp_path / "b"), remote=remote,
                                 plan_kwargs={"device": "cpu"})
    reg = PlanRegistry(store=b)
    sig2, plan2 = reg.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM, tr,
                                   device="cpu")
    assert sig2 == sig and reg.stats()["builds"] == 0
    assert os.path.exists(b.artifact_path(key))  # written through
    v = np.random.default_rng(1).standard_normal(
        (plan.index_plan.num_values, 2)).astype(np.float32)
    assert torch.equal(plan2.backward(v), plan.backward(v))
    got = obs.GLOBAL_COUNTERS.get("spfft_store_remote_total", op="get",
                                  outcome="hit")
    assert got >= 1


def test_store_remote_failure_is_a_counted_miss(tmp_path):
    remote = str(tmp_path / "remote")
    a = tstore.PlanArtifactStore(str(tmp_path / "a"), remote=remote,
                                 plan_kwargs={"device": "cpu"})
    _, tr, sig, _ = _build(a)
    b = tstore.PlanArtifactStore(str(tmp_path / "b"), remote=remote,
                                 plan_kwargs={"device": "cpu"})
    faults.arm(faults.FaultPlan(script="blob.get@*"))
    reg = PlanRegistry(store=b)
    reg.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM, tr, device="cpu")
    faults.disarm()
    assert reg.stats()["builds"] == 1
    assert obs.GLOBAL_COUNTERS.get("spfft_store_remote_total", op="get",
                                   outcome="error") >= 1


def test_blobstore_module_serves(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spfft_tpu_torch.net.blobstore", "--serve",
         str(tmp_path / "srv")], stdout=subprocess.PIPE, text=True,
        env=env, cwd=REPO)
    try:
        line = json.loads(proc.stdout.readline())
        client = tblob.HttpBlobStore(f"http://127.0.0.1:{line['port']}")
        client.put("torch/art/k.plan", b"payload")
        assert client.get("torch/art/k.plan") == b"payload"
        assert line["blobstore"] == str(tmp_path / "srv")
    finally:
        proc.terminate()
        proc.wait(30)
