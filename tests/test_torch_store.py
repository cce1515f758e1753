"""The port's plan-artifact store (``spfft_tpu_torch.serve.store``) on the
CPU, against the JAX package's store (``spfft_tpu.serve.store``).

* save / load round trips bit for bit (C2C and R2C, both routes, single
  and double), a warm registry resolving with ``builds == 0``;
* every reject reason (corrupt, version_mismatch, digest_mismatch, io,
  incompatible, degraded) under the same damage as the JAX package's
  store, with the JAX package's label;
* a JAX store and a port store on ONE directory: each loads its own
  artifact (``builds == 0``), refuses the other's bytes (``corrupt``, the
  magic) and rebuilds, and neither's ``gc`` / ``verify`` / ``manifest``
  touches or lists the other's files;
* a table corrupted behind a valid checksum is refused by
  ``restore_plan``'s range checks (``InvalidParameterError``), counted
  ``corrupt`` and rebuilt;
* the CLI: ``seed`` / ``manifest`` / ``prewarm --compile --strict
  --json`` in a fresh process (``builds == 0``) / ``verify`` / ``gc``,
  the live manifest, the executor's boot prewarm and the default store.
"""

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spfft_tpu import TransformType as JTT
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg
from spfft_tpu.serve import PlanRegistry as JRegistry
from spfft_tpu.serve import store as jstore

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.errors import InvalidParameterError, PlanArtifactError
from spfft_tpu_torch.serve import PlanRegistry, ServeExecutor
from spfft_tpu_torch.serve import store as tstore
from spfft_tpu_torch.utils.workloads import (sort_triplets_stick_major,
                                             spherical_cutoff_triplets)

torch.set_num_threads(2)

DIM = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(tstore.PLAN_STORE_ENV, raising=False)
    monkeypatch.delenv(tstore.PLAN_MANIFEST_ENV, raising=False)
    monkeypatch.delenv(tstore.BLOB_STORE_ENV, raising=False)

    def reset():
        for f, o, c in ((faults, obs, tcfg), (jfaults, jobs, jcfg)):
            f.disarm()
            o.GLOBAL_COUNTERS.reset()
            c.set_global_config(None)
    reset()
    yield
    reset()


def _triplets(dim=DIM, r2c=False):
    tr = sort_triplets_stick_major(spherical_cutoff_triplets(dim),
                                   (dim, dim, dim))
    return tr[tr[:, 0] >= 0] if r2c else tr


def _values(plan, seed=7):
    rng = np.random.default_rng(seed)
    dt = np.float32 if plan.precision == "single" else np.float64
    return rng.standard_normal((plan.index_plan.num_values, 2)).astype(dt)


def _port_store(root, r2c=False, **kw):
    store = tstore.PlanArtifactStore(str(root), plan_kwargs=CPU)
    reg = PlanRegistry(store=store)
    tr = _triplets(r2c=r2c)
    tt = sp.TransformType.R2C if r2c else sp.TransformType.C2C
    sig, plan = reg.get_or_build(tt, DIM, DIM, DIM, tr, device="cpu", **kw)
    store.drain()
    return store, reg, tr, sig, plan


def _jax_store(root, **kw):
    store = jstore.PlanArtifactStore(str(root))
    reg = JRegistry(store=store)
    tr = _triplets()
    sig, plan = reg.get_or_build(JTT.C2C, DIM, DIM, DIM, tr, **kw)
    store.drain()
    return store, reg, tr, sig, plan


def _split(path, magic):
    data = open(path, "rb").read()
    off = len(magic)
    hlen = int(data[off:off + 16], 16)
    off += 17
    return json.loads(data[off:off + hlen]), data[off + hlen:]


def _rewrite(path, magic, header, payload):
    header = dict(header)
    header["payload_sha256"] = hashlib.sha256(payload).hexdigest()
    header["payload_len"] = len(payload)
    hbytes = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(b"".join([magic, b"%016x\n" % len(hbytes), hbytes,
                          payload]))


def _edit_payload(path, magic, edit):
    header, payload = _split(path, magic)
    with np.load(io.BytesIO(payload)) as z:
        arrays = {k: z[k].copy() for k in z.files}
    edit(arrays)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _rewrite(path, magic, header, buf.getvalue())


# -- round trips ---------------------------------------------------------------
@pytest.mark.parametrize("r2c,fused,precision", [
    (False, True, "single"), (True, True, "single"),
    (False, False, "single"), (True, False, "double")])
def test_roundtrip_bit_exact(tmp_path, r2c, fused, precision):
    store, reg, tr, sig, plan = _port_store(tmp_path, r2c=r2c, fused=fused,
                                            precision=precision)
    vals = _values(plan)
    want_b = plan.backward(vals)
    want_f = plan.forward(want_b, sp.Scaling.FULL)
    got = tstore.PlanArtifactStore(store.root,
                                   plan_kwargs=CPU).load_signature(sig)
    assert got is not None
    sig2, plan2 = got
    assert sig2 == sig and plan2.fused_active == plan.fused_active
    assert torch.equal(plan2.backward(vals), want_b)
    assert torch.equal(plan2.forward(want_b, sp.Scaling.FULL), want_f)
    header, _ = _split(store.artifact_path(tstore.signature_key(sig)),
                       tstore.MAGIC)
    assert header["meta"]["aot"] == {} and header["meta"]["backend"] == "cpu"


def test_warm_registry_resolves_with_zero_builds(tmp_path):
    store, reg, tr, sig, plan = _port_store(tmp_path)
    assert reg.stats()["builds"] == 1 and reg.stats()["store_spills"] == 1
    reg2 = PlanRegistry(store=tstore.PlanArtifactStore(store.root,
                                                       plan_kwargs=CPU))
    sig2, plan2 = reg2.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM, tr,
                                    device="cpu")
    st = reg2.stats()
    assert sig2 == sig and st["builds"] == 0 and st["store_hits"] == 1
    vals = _values(plan)
    assert torch.equal(plan2.backward(vals), plan.backward(vals))
    # a different spelling of the set resolves through the signature tier
    centered = tr.copy()
    centered[:, 2] = np.where(centered[:, 2] > DIM // 2,
                              centered[:, 2] - DIM, centered[:, 2])
    reg3 = PlanRegistry(store=tstore.PlanArtifactStore(store.root,
                                                       plan_kwargs=CPU))
    sig3, _ = reg3.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM,
                                centered, device="cpu")
    assert sig3 == sig and reg3.stats()["builds"] == 0
    assert reg3.stats()["store_hits"] == 1


# -- reject reasons, each beside the JAX package's label ---------------------
def _damage(kind, store, sig, magic, package):
    path = store.artifact_path(
        (tstore if package == "port" else jstore).signature_key(sig))
    if kind == "flip":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-64] + b"\x00" * 64)
    elif kind == "truncate":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
    elif kind == "garbage":
        open(path, "wb").write(b"not an artifact at all")
    elif kind in ("format", "schema"):
        header, payload = _split(path, magic)
        if kind == "format":
            header["format_version"] = 999
        else:
            header["table_schema"] = 0
        _rewrite(path, magic, header, payload)
    elif kind == "digest":
        def edit(a):
            a["stick_keys"][0] += 1
        _edit_payload(path, magic, edit)
    elif kind == "io":
        os.unlink(path)
        os.mkdir(path)  # reading a directory fails with an OSError
    return path


DAMAGE = {"flip": "corrupt", "truncate": "corrupt", "garbage": "corrupt",
          "format": "version_mismatch", "schema": "version_mismatch",
          "digest": "digest_mismatch", "io": "io"}


@pytest.mark.parametrize("kind", sorted(DAMAGE))
def test_reject_reason_matches_the_jax_store(tmp_path, kind):
    got = {}
    for package in ("port", "jax"):
        root = tmp_path / package
        if package == "port":
            store, _, tr, sig, plan = _port_store(root)
            fresh = tstore.PlanArtifactStore(store.root, plan_kwargs=CPU)
            magic = tstore.MAGIC
        else:
            store, _, tr, sig, plan = _jax_store(root)
            fresh = jstore.PlanArtifactStore(store.root)
            magic = jstore.MAGIC
        _damage(kind, store, sig, magic, package)
        assert fresh.load_signature(sig) is None
        got[package] = fresh.stats()["rejects"]
    assert got["port"] == got["jax"] == {DAMAGE[kind]: 1}


def test_damaged_artifact_rebuilds_bit_exact(tmp_path):
    store, reg, tr, sig, plan = _port_store(tmp_path)
    _damage("flip", store, sig, tstore.MAGIC, "port")
    reg2 = PlanRegistry(store=tstore.PlanArtifactStore(store.root,
                                                       plan_kwargs=CPU))
    sig2, plan2 = reg2.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM, tr,
                                    device="cpu")
    assert sig2 == sig and reg2.stats()["builds"] == 1
    assert reg2.store.stats()["rejects"] == {"corrupt": 2}
    vals = _values(plan)
    assert torch.equal(plan2.backward(vals), plan.backward(vals))


def test_incompatible_route_matches_the_jax_label(tmp_path):
    # the JAX package: use_pallas=True asked of an artifact without its
    # kernel tables; the port: fused=True asked of tables built for the
    # two-kernel route
    _, _, _, jsig, _ = _jax_store(tmp_path / "jax")
    js = jstore.PlanArtifactStore(str(tmp_path / "jax"))
    assert js.load_signature(jsig, plan_kwargs={"use_pallas": True}) is None
    store, _, tr, sig, _ = _port_store(tmp_path / "port", fused=False)
    ts = tstore.PlanArtifactStore(store.root, plan_kwargs=CPU)
    assert ts.load_signature(sig, plan_kwargs={"fused": True}) is None
    assert ts.stats()["rejects"] == js.stats()["rejects"] == \
        {"incompatible": 1}
    # and the converse: fused=False asked of fused tables
    store2, _, _, sig2, _ = _port_store(tmp_path / "port2")
    ts2 = tstore.PlanArtifactStore(store2.root, plan_kwargs=CPU)
    assert ts2.load_signature(sig2, plan_kwargs={"fused": False}) is None
    assert ts2.stats()["rejects"] == {"incompatible": 1}


def test_degraded_spill_matches_the_jax_label(tmp_path):
    labels = {}
    for package, mk, fm in (("port", _port_store, faults),
                            ("jax", _jax_store, jfaults)):
        store, _, _, sig, plan = mk(tmp_path / package)
        mod = tstore if package == "port" else jstore
        os.unlink(store.artifact_path(mod.signature_key(sig)))
        fm.arm(fm.FaultPlan(script="store.spill@1:enospc"))
        try:
            with pytest.raises(OSError):
                store.save_plan(sig, plan)
        finally:
            fm.disarm()
        assert store.degraded and store.health()["mode"] == "memory-only"
        store.save_plan(sig, plan)  # skipped, counted
        assert not os.path.exists(store.artifact_path(
            mod.signature_key(sig)))
        labels[package] = store.stats()["rejects"]
        store._reprobe_at = 0.0  # a due re-probe lifts the degradation
        store.save_plan(sig, plan)
        assert not store.degraded
    assert labels["port"] == labels["jax"] == {"degraded": 1}


def test_corrupted_table_is_refused_by_the_range_checks(tmp_path):
    store, reg, tr, sig, plan = _port_store(tmp_path)
    path = store.artifact_path(tstore.signature_key(sig))

    def edit(a):
        a["tab.csr_val"][3] = plan.index_plan.num_values + 5  # out of range
    _edit_payload(path, tstore.MAGIC, edit)  # checksum recomputed: valid
    header, arrays = tstore.parse_artifact(open(path, "rb").read())
    tabs = tstore._plan_tables_of(header, arrays)
    ip = tstore._index_plan_of(header, arrays)
    with pytest.raises(InvalidParameterError, match="csr_val"):
        sp.restore_plan(ip, tabs, device="cpu")
    fresh = tstore.PlanArtifactStore(store.root, plan_kwargs=CPU)
    reg2 = PlanRegistry(store=fresh)
    sig2, plan2 = reg2.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM, tr,
                                    device="cpu")
    # the raw-request alias and the signature tier each refuse it, as in
    # the JAX package
    assert fresh.stats()["rejects"] == {"corrupt": 2}
    assert reg2.stats()["builds"] == 1
    vals = _values(plan)
    assert torch.equal(plan2.backward(vals), plan.backward(vals))


# -- one directory, two packages -------------------------------------------------
def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_shared_directory_each_package_keeps_its_own(tmp_path):
    root = tmp_path / "shared"
    ts, treg, tr, tsig, tplan = _port_store(root)
    js, jreg, _, jsig, jplan = _jax_store(root)
    assert tsig.__dict__ == jsig.__dict__  # one signature, two artifacts
    # one key, two places: the port's under its own subdirectory
    tkey, jkey = tstore.signature_key(tsig), jstore.signature_key(jsig)
    assert tkey == jkey
    rargs = ("c2c", DIM, DIM, DIM, tr, "single", "none")
    assert tstore.request_key(*rargs) == jstore.request_key(*rargs)
    tpath, jpath = ts.artifact_path(tkey), js.artifact_path(jkey)
    assert tpath != jpath
    assert os.path.exists(tpath) and os.path.exists(jpath)
    # each loads its own, with no build
    r1 = PlanRegistry(store=tstore.PlanArtifactStore(str(root),
                                                     plan_kwargs=CPU))
    r1.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM, tr, device="cpu")
    r2 = JRegistry(store=jstore.PlanArtifactStore(str(root)))
    r2.get_or_build(JTT.C2C, DIM, DIM, DIM, tr)
    assert r1.stats()["builds"] == 0 and r2.stats()["builds"] == 0
    # each lists only its own
    assert [r["key"] for r in ts.verify()] == [tkey]
    assert [r["key"] for r in js.verify()] == [jkey]
    assert [e["artifact"] for e in ts.manifest()["entries"]] == [tkey]
    assert [e["artifact"] for e in js.manifest()["entries"]] == [jkey]
    # each refuses the other's bytes (typed), and deletes nothing of it
    jbytes, tbytes = open(jpath, "rb").read(), open(tpath, "rb").read()
    with pytest.raises(tstore.StoreReject) as exc:
        tstore.parse_artifact(jbytes)
    assert exc.value.reason == "corrupt"
    with pytest.raises(jstore.StoreReject) as exc:
        jstore.parse_artifact(tbytes)
    assert exc.value.reason == "corrupt"
    open(tpath, "wb").write(jbytes)  # the JAX artifact where the port looks
    fresh = tstore.PlanArtifactStore(str(root), plan_kwargs=CPU)
    r3 = PlanRegistry(store=fresh)
    sig3, plan3 = r3.get_or_build(sp.TransformType.C2C, DIM, DIM, DIM, tr,
                                  device="cpu")
    fresh.drain()
    # the raw-request alias and the signature tier each refuse it, as in
    # the JAX package
    assert fresh.stats()["rejects"] == {"corrupt": 2}
    assert r3.stats()["builds"] == 1
    assert open(jpath, "rb").read() == jbytes
    assert open(tpath, "rb").read()[:len(tstore.MAGIC)] == tstore.MAGIC
    vals = _values(tplan)
    assert torch.equal(plan3.backward(vals), tplan.backward(vals))
    # gc by either leaves the other's files as they were
    before = _files(root)
    ts.gc(max_bytes=1)
    after = _files(root)
    assert {k: v for k, v in after.items() if not k.startswith("torch")} \
        == {k: v for k, v in before.items() if not k.startswith("torch")}
    ts.save_plan(tsig, tplan, tr)
    before = _files(root)
    js.gc(max_bytes=1)
    after = _files(root)
    assert {k: v for k, v in after.items() if k.startswith("torch")} \
        == {k: v for k, v in before.items() if k.startswith("torch")}


def test_manifests_of_the_other_package_are_refused(tmp_path):
    root = tmp_path / "s"
    ts, _, _, _, _ = _port_store(root)
    js, _, _, _, _ = _jax_store(root)
    jm = str(tmp_path / "jax_manifest.json")
    js.write_manifest(jm)
    with pytest.raises(InvalidParameterError, match="spfft_tpu_torch"):
        tstore.load_manifest(jm)
    with pytest.raises(InvalidParameterError):
        ts.append_manifest_entry(jm, {"artifact": "x"})
    assert json.load(open(jm))[jstore.MANIFEST_KEY] == 1  # not clobbered


# -- the CLI, manifests and boot ---------------------------------------------
def _cli(args, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m",
                           "spfft_tpu_torch.serve.store"] + args,
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO, **kw)


def test_prewarm_subprocess_strict_json_zero_builds(tmp_path):
    store, reg, tr, sig, plan = _port_store(tmp_path / "s")
    proc = _cli(["prewarm", store.root, "--compile", "--strict", "--json",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["builds"] == 0 and report["loaded"] == 1
    assert report["store"]["hits"] == 1 and report["store"]["rejects"] == {}
    assert report["compile_events"]["store_load"] == 1


def test_cli_seed_reference_manifest_verify_gc(tmp_path):
    root = str(tmp_path / "cli")
    proc = _cli(["seed", root, "--dim", "12", "--reference", "--json",
                 "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    seed = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seed["builds"] == 1 and seed["store"]["spills"] == 1
    proc = _cli(["manifest", root])
    assert json.loads(proc.stdout)["entries"] == 1
    manifest = os.path.join(root, "torch", "manifest.json")
    proc = _cli(["prewarm", root, "--manifest", manifest, "--compile",
                 "--check-reference", "--strict", "--json", "--device",
                 "cpu"])
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["reference_bit_exact"] and report["builds"] == 0
    proc = _cli(["verify", root, "--json"])
    assert proc.returncode == 0 and json.loads(proc.stdout)["bad"] == 0
    proc = _cli(["gc", root, "--max-bytes", "1"])
    assert len(json.loads(proc.stdout)["removed"]) == 1
    proc = _cli(["prewarm", root, "--strict", "--json", "--device", "cpu"])
    assert proc.returncode == 1  # nothing to load


def test_live_manifest_and_executor_boot_prewarm(tmp_path, monkeypatch):
    manifest = str(tmp_path / "live.json")
    monkeypatch.setenv(tstore.PLAN_MANIFEST_ENV, manifest)
    store, reg, tr, sig, plan = _port_store(tmp_path / "s")
    m = tstore.load_manifest(manifest)
    assert [e["artifact"] for e in m["entries"]] == \
        [tstore.signature_key(sig)]
    assert m["entries"][0]["aot"] == []
    reg2 = PlanRegistry(store=tstore.PlanArtifactStore(store.root,
                                                       plan_kwargs=CPU))
    with ServeExecutor(reg2, autostart=False) as ex:
        assert sig in reg2 and reg2.stats()["builds"] == 0
        assert ex.registry is reg2
    # a strict warmup of an artifact no tier holds raises typed
    with pytest.raises(PlanArtifactError):
        reg2.warmup([{"artifact": "0" * 64}])


def test_default_store_from_env_and_config(tmp_path, monkeypatch):
    monkeypatch.setenv(tstore.PLAN_STORE_ENV, str(tmp_path / "env"))
    reg = PlanRegistry()
    assert reg.store is not None and reg.store.root == str(tmp_path / "env")
    cfg = tcfg.ServeConfig()
    cfg.set_path("plan_store_path", str(tmp_path / "cfg"))
    tcfg.set_global_config(cfg)
    assert tstore.default_store().root == str(tmp_path / "cfg")
    assert tstore.default_store() is tstore.default_store()
