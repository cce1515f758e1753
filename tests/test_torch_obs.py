"""The port's observability (``spfft_tpu_torch.obs``) against the JAX
package's (``spfft_tpu.obs``): the metric registry, counters, spans and
the deterministic sampler driven by the same call sequence; the
Prometheus text byte for byte equal; the trace export's structure; the
``MetricsServer`` scrape endpoint on port 0 of the loopback; and the
records the plans emit."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from spfft_tpu import obs as jobs
from spfft_tpu import timing as jtiming

import spfft_tpu_torch as sp
from spfft_tpu_torch import obs, timing
from spfft_tpu_torch.obs import counters as tcounters
from spfft_tpu_torch.obs import trace as ttrace

torch.set_num_threads(2)

PKGS = ((obs, timing), (jobs, jtiming))


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for o, _ in PKGS:
            o.disable()
            o.GLOBAL_COUNTERS.reset()
            o.GLOBAL_TRACER.reset()
            o.GLOBAL_TRACER.set_sample_rate(1.0)
            o.reset_recorder()
    reset()
    yield
    reset()


def test_metric_specs_equal_jax_but_the_hlo_gauges():
    from spfft_tpu.obs import counters as jcounters
    hlo = {k for k in jcounters.METRIC_SPECS if k.startswith("spfft_hlo_")}
    assert hlo == {"spfft_hlo_collectives", "spfft_hlo_async_starts",
                   "spfft_hlo_async_dones"}
    want = {k: v for k, v in jcounters.METRIC_SPECS.items() if k not in hlo}
    assert tcounters.METRIC_SPECS == want
    assert list(tcounters.METRIC_SPECS) == list(want)
    assert not hasattr(obs, "record_hlo_counts")
    assert set(obs.__all__) == set(jobs.__all__) - {"record_hlo_counts"}


def _record(o):
    """One call sequence through every counter helper of a package."""
    c = o.GLOBAL_COUNTERS
    c.inc("spfft_plan_builds_total", kind="local")
    c.inc("spfft_plan_builds_total", 2, kind="local")
    c.set("spfft_wire_rung", 3, exchange="buffered", shards="4", chunks="1")
    c.inc("spfft_custom_total", 1.5, help="A custom series.", a="x\"y\n")
    o.record_plan_fallback("fused_decompress_zdft", "dimz_over_cap")
    o.record_compile("kernel_build", 0.25, source="fft.cu")
    for ev in ("hit", "miss", "spill", "evict", "manifest_refresh"):
        o.record_store(ev)
    o.record_store("reject", reason="version")
    o.record_store_aot_skip("platform")


@pytest.mark.parametrize("traced", [False, True])
def test_counters_and_prometheus_text_byte_equal(traced):
    for o, tm in PKGS:
        if traced:
            o.enable()
        _record(o)
    t_text = obs.prometheus_text(timer=timing.Timer())
    j_text = jobs.prometheus_text(timer=jtiming.Timer())
    assert t_text == j_text
    assert obs.GLOBAL_COUNTERS.snapshot() == jobs.GLOBAL_COUNTERS.snapshot()
    parsed = obs.parse_prometheus_text(t_text)
    assert parsed == jobs.parse_prometheus_text(j_text)
    assert parsed[("spfft_plan_builds_total", (("kind", "local"),))] == 3.0
    if traced:
        names = [getattr(e, "name", None) or e["name"]
                 for e in obs.GLOBAL_TRACER.events()]
        assert names == [getattr(e, "name", None) or e["name"]
                         for e in jobs.GLOBAL_TRACER.events()]
        assert "compile.kernel_build" in names


def test_prometheus_text_with_timer_and_serving_snapshots():
    snap = {"completed": 3, "failed": 1, "queue_depth": 2,
            "latency_seconds": {"p50": 0.01, "p99": 0.5},
            "completed_by_class": {"high": 2},
            "fused_batch_histogram": {"2": 1},
            "overhead_seconds": {"stage_total": 0.125},
            "health": {"state": "degraded", "retries": 2,
                       "retries_by_class": {"low": 1}},
            "registry": {"plans": 2, "hits": 5}}
    texts = []
    for o, tm in PKGS:
        timer = tm.Timer()
        with timer.scoped("backward"):
            with timer.scoped("z"):
                pass
        texts.append(o.prometheus_text(metrics=snap, timer=timer))
    # the timer's seconds differ between the runs; everything else not
    strip = [[ln for ln in t.splitlines()
              if not ln.startswith("spfft_timing_seconds_total")]
             for t in texts]
    assert strip[0] == strip[1]
    assert 'spfft_timing_calls_total{scope="backward/z"} 1' in texts[0]
    with pytest.raises(ValueError):
        obs.parse_prometheus_text("spfft_untyped 1\n")
    with pytest.raises(ValueError):
        obs.parse_prometheus_text("# TYPE a counter\na{b=c} 1\n")


def test_counter_checks_match_jax():
    for o, _ in PKGS:
        c = o.GLOBAL_COUNTERS
        with pytest.raises(ValueError):
            c.set("spfft_plan_builds_total", 1)  # declared a counter
        with pytest.raises(ValueError):
            c.inc("bad name")
        with pytest.raises(ValueError):
            c.inc("spfft_x_total", **{"bad-label": 1})
        c.set("spfft_free_gauge", 1)
        with pytest.raises(ValueError):
            c.inc("spfft_free_gauge")
        assert c.get("spfft_nothing") == 0.0


def _spans(o):
    t = o.Tracer(max_events=8)
    with t.span("outer", track="compile", args={"n": 1}):
        s = t.begin("inner", cat="plan", trace_id=7)
        t.finish(s, args={"k": "v"})
        t.finish(s)  # idempotent
    with pytest.raises(KeyError):
        with t.span("failing"):
            raise KeyError("x")
    t.complete("done", 1.0, 2.5, track="exchange", status="error",
               error="E")
    t.instant("mark", track="control", trace_id=3, args={"a": 1})
    t.counter("bytes", {"bwd": 4, "fwd": 2}, track="exchange")
    rt = o.RequestTrace(t, "high", args={"r": 1})
    rt.begin("serve.stage")
    rt.annotate("retry", n=1)
    rt.close(status="error", error="Boom")
    for i in range(6):
        t.instant(f"fill{i}")
    return t


def _shape(events):
    """The trace events without times and ids."""
    out = []
    for e in events:
        d = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        d["args"] = {k: v for k, v in (d.get("args") or {}).items()
                     if k not in ("span_id", "parent_span_id", "trace_id")}
        out.append(d)
    return out


def test_spans_and_trace_events_match_jax():
    tt, jt = _spans(ttrace), _spans(__import__(
        "spfft_tpu.obs.trace", fromlist=["x"]))
    assert tt.stats() == jt.stats()
    assert tt.stats()["dropped"] > 0 and tt.open_count() == 0
    te = obs.trace_events(tt)
    je = jobs.trace_events(jt)
    assert te[0]["args"]["name"] == "spfft_tpu_torch"
    assert _shape(te[1:]) == _shape(je[1:])
    ctx = ttrace.span_context(tt.begin("x", trace_id=5))
    assert ttrace.TraceContext.from_wire(ctx.to_wire()) == ctx
    assert ttrace.span_context(None) is None


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.5, 1.0])
def test_deterministic_sampling_matches_jax(rate):
    got = []
    for o, _ in PKGS:
        t = o.Tracer()
        t.set_sample_rate(rate)
        got.append([t.sample() for _ in range(40)])
    assert got[0] == got[1]
    ttrace.force_sampling(True)
    try:
        t = ttrace.Tracer()
        t.set_sample_rate(0.0)
        assert t.sample()
    finally:
        ttrace.force_sampling(False)


def test_export_trace_structure(tmp_path):
    obs.enable()
    assert obs.active()
    obs.record_compile("kernel_build", 0.5, source="gather.cu")
    obs.GLOBAL_TRACER.counter("exchange.chunk_wire_bytes", {"bwd": 1},
                              track="exchange")
    path = tmp_path / "trace.json"
    payload = obs.export_trace(str(path))
    data = json.loads(path.read_text())
    assert data == json.loads(json.dumps(payload))
    assert data["displayTimeUnit"] == "ms"
    assert data["otherData"]["producer"] == "spfft_tpu_torch.obs"
    assert data["otherData"]["tracer"]["closed"] == 1
    phs = [e["ph"] for e in data["traceEvents"]]
    assert phs[0] == "M" and "X" in phs and "C" in phs
    names = {e["args"]["name"] for e in data["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {"compile", "exchange"}
    x = next(e for e in data["traceEvents"] if e["ph"] == "X")
    assert x["name"] == "compile.kernel_build" and x["dur"] == 5e5
    obs.disable()
    assert not obs.active()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def test_metrics_server_on_port_zero(monkeypatch):
    _record(obs)
    with obs.MetricsServer(port=0) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        code, ctype, body = _get(srv.url + "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert obs.parse_prometheus_text(body) == \
            obs.parse_prometheus_text(obs.prometheus_text())
        code, _, body = _get(srv.url + "/healthz")
        assert code == 503 and json.loads(body) == {"state": "unknown"}
        assert _get(srv.url + "/configz")[0] == 404
        assert _get(srv.url + "/incidentz")[0] == 503  # recorder disarmed
        assert _get(srv.url + "/nosuch")[0] == 404
    healthy = obs.MetricsServer(health_fn=lambda: {"state": "healthy"},
                                text_fn=lambda: "# TYPE a gauge\na 1\n")
    port = healthy.start()
    assert healthy.start() == port  # idempotent
    try:
        assert _get(healthy.url + "/healthz")[0] == 200
        assert _get(healthy.url + "/metrics")[2] == "# TYPE a gauge\na 1\n"
    finally:
        healthy.stop()
    monkeypatch.setenv(obs.METRICS_PORT_ENV, "9123")
    assert obs.port_from_env() == 9123
    monkeypatch.setenv(obs.METRICS_PORT_ENV, "nope")
    assert obs.port_from_env() is None


def test_plan_build_records_match_jax():
    """A local plan's construction records one plan build of kind local
    in both packages; with tracing on, a ``compile.plan_build`` span with
    the plan's precision and dims."""
    import spfft_tpu
    obs.enable()
    jobs.enable()
    trip = np.array([[x, y, z] for x in range(4) for y in range(3)
                     for z in range(5)], np.int32)
    tp = sp.make_local_plan(sp.TransformType.C2C, 4, 3, 5, trip,
                            device="cpu")
    spfft_tpu.make_local_plan(spfft_tpu.TransformType.C2C, 4, 3, 5, trip)
    for o in (obs, jobs):
        assert o.GLOBAL_COUNTERS.get("spfft_plan_builds_total",
                                     kind="local") == 1
        assert o.GLOBAL_COUNTERS.get("spfft_plan_build_seconds_total",
                                     kind="local") > 0
    span = next(e for e in obs.GLOBAL_TRACER.events()
                if getattr(e, "name", "") == "compile.plan_build")
    assert span.args == {"kind": "local", "precision": "single",
                         "dims": "4x3x5"}
    tp.backward(np.ones((tp.num_local_elements, 2), np.float32))
    assert obs.GLOBAL_TRACER.open_count() == 0
