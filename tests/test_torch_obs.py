"""The port's observability layer (``repro_torch.obs``, ``serving.metrics``)
against the JAX package's: the same seeded observations through both
packages give the same histogram and metrics states (field for field),
each package loads the other's state, merges agree, the Prometheus text
is byte-identical and each package parses the other's.  Everything
compared is exact (no tolerance): both packages run the same float
arithmetic on the same Python floats."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

import repro.obs.histogram as jhist
import repro.obs.prometheus as jprom
import repro.obs.trace as jtrace
import repro.obs.window as jwindow
import repro.serving.metrics as jmetrics
import repro_torch.obs.histogram as thist
import repro_torch.obs.prometheus as tprom
import repro_torch.obs.trace as ttrace
import repro_torch.obs.window as twindow
import repro_torch.serving.metrics as tmetrics
from repro_torch.obs import profiler as tprofiler

JAX, PORT = "jax", "port"
PKG = {
    JAX: dict(hist=jhist, prom=jprom, trace=jtrace, window=jwindow, metrics=jmetrics),
    PORT: dict(hist=thist, prom=tprom, trace=ttrace, window=twindow, metrics=tmetrics),
}
HOSTILE = 'evil\\model"with\nall three'


def _observations(seed: int, n: int = 200) -> list[float]:
    """Seconds spread over the buckets, a zero, a negative (clamped) and
    one past the last bound (the overflow bucket)."""
    rng = np.random.default_rng(seed)
    xs = (10.0 ** rng.uniform(-6.5, 1.5, n)).tolist()
    return xs + [0.0, -1.0, 100.0]


def _hist(pkg: str, seed: int):
    h = PKG[pkg]["hist"].LatencyHistogram()
    for i, v in enumerate(_observations(seed)):
        h.observe(v, exemplar=f"req-{i}" if i % 7 == 0 else None)
    return h


def _metrics(pkg: str, seed: int):
    """A ServingMetrics fed one seeded sequence of every mutator."""
    rng = np.random.default_rng(seed)
    m = PKG[pkg]["metrics"].ServingMetrics()
    for i, v in enumerate(_observations(seed, 60)):
        m.enqueued(int(rng.integers(1, 9)))
        m.observe_batch(int(rng.integers(1, 9)), 8)
        m.observe_request(abs(v), error=bool(i % 11 == 0), exemplar=f"r{i}")
        for stage in ("queue", "assembly", "device", "write"):
            m.observe_stage(stage, abs(v) / (1 + len(stage)))
    m.observe_stage("custom", 0.25)  # a stage registered lazily
    m.observe_reload()
    m.shed(3)
    m.rejected(2)
    m.dropped(1)
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_bounds_and_histogram_state_equal_jax(seed):
    assert thist.log_bounds() == jhist.log_bounds()
    assert thist.log_bounds(1e-3, 10.0, 4) == jhist.log_bounds(1e-3, 10.0, 4)
    want, got = _hist(JAX, seed), _hist(PORT, seed)
    assert got.state() == want.state()
    assert json.dumps(got.state()) == json.dumps(want.state())
    assert got.snapshot() == want.snapshot()
    assert got.cumulative() == want.cumulative()
    for p in (0.0, 1.0, 50.0, 90.0, 99.0, 100.0):
        assert got.percentile(p) == want.percentile(p)
    for t in (1e-5, 1e-3, 0.5):
        assert got.count_over(t) == want.count_over(t)


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)])
def test_histogram_state_loads_in_the_other_package_and_merges_equal(src, dst):
    state = json.loads(json.dumps(_hist(src, 3).state()))
    loaded = PKG[dst]["hist"].LatencyHistogram.from_state(state)
    assert loaded.state() == state
    merged = loaded.merge(_hist(dst, 4))
    want = _hist(JAX, 3).merge(_hist(JAX, 4))
    assert merged.state() == want.state()
    assert merged.percentiles_ms() == want.percentiles_ms()
    with pytest.raises(ValueError, match="count"):
        PKG[dst]["hist"].LatencyHistogram.from_state(dict(state, count=state["count"] + 1))


@pytest.mark.parametrize("seed", [0, 5])
def test_serving_metrics_state_equal_jax(seed):
    want, got = _metrics(JAX, seed), _metrics(PORT, seed)
    assert got.state() == want.state()
    assert json.dumps(got.state()) == json.dumps(want.state())
    assert got.COUNTERS == want.COUNTERS
    a, b = got.snapshot(), want.snapshot()
    for key in ("elapsed_s", "throughput_rps"):  # wall-clock readings of each instance
        a.pop(key), b.pop(key)
    assert a == b


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)])
def test_serving_metrics_state_round_trips_between_the_packages(src, dst):
    state = json.loads(json.dumps(_metrics(src, 6).state()))
    loaded = PKG[dst]["metrics"].ServingMetrics.from_state(state)
    assert loaded.state() == state
    merged = loaded.merge(_metrics(dst, 7))
    want = _metrics(JAX, 6).merge(_metrics(JAX, 7))
    assert merged.state() == want.state()


class _Stub:
    """A duck-typed registry: one single-engine entry, one pool entry
    (per-replica metrics), a watcher and a learner, all made by one
    package from the same seeds."""

    def __init__(self, pkg: str):
        metrics = lambda s: _metrics(pkg, s)  # noqa: E731
        self.entries = {
            HOSTILE: type("B", (), {"metrics": metrics(1)})(),
            "pooled": type("P", (), {
                "metrics": metrics(2),
                "replicas": [type("R", (), {"metrics": metrics(s)})() for s in (3, 4)],
            })(),
        }
        self.watchers = {"pooled": type("W", (), {
            "n_polls": 9, "n_promotions": 2, "n_errors": 0, "last_step": 7,
            "promote_hist": _hist(pkg, 8),
        })()}
        snap = {"n_ingested": 50, "n_trained": 40, "n_shed": 1, "n_published": 3,
                "n_errors": 0, "buffered": 10, "lag_examples": 10, "staleness_s": 0.125}
        self.learners = {HOSTILE: type("L", (), {
            "snapshot": lambda self: dict(snap),
            "publish_hist": _hist(pkg, 9),
            "metrics": metrics(10),
        })()}

    def names(self):
        return tuple(sorted(self.entries))

    def batcher(self, name):
        return self.entries[name]

    def watcher(self, name):
        return self.watchers.get(name)

    def learner(self, name):
        return self.learners.get(name)


def test_render_prometheus_text_is_byte_identical_to_jax():
    want = jprom.render_prometheus(_Stub(JAX))
    got = tprom.render_prometheus(_Stub(PORT))
    assert got == want
    assert 'model="evil\\\\model\\"with\\nall three"' in got
    for family in ("uhd_watcher_promote_seconds_bucket", "uhd_online_publish_seconds_bucket",
                   "uhd_online_stage_latency_seconds_bucket", "uhd_stage_latency_seconds_bucket"):
        assert family in got


@pytest.mark.parametrize("writer,parser", [(JAX, PORT), (PORT, JAX)])
def test_each_package_parses_the_others_exposition(writer, parser):
    text = PKG[writer]["prom"].render_prometheus(_Stub(writer))
    parsed = PKG[parser]["prom"].parse_exposition(text)
    assert parsed == PKG[writer]["prom"].parse_exposition(text)
    types, helps, samples = parsed
    assert types["uhd_request_latency_seconds"] == "histogram"
    assert {ls["model"] for n, ls, _ in samples if n == "uhd_queue_depth"} == {HOSTILE, "pooled"}
    replicas = {ls.get("replica") for n, ls, _ in samples
                if n == "uhd_requests_total" and ls["model"] == "pooled"}
    assert replicas == {"pool", "0", "1"}


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_hostile_label_round_trips_through_writer(pkg):
    w = PKG[pkg]["prom"].Writer()
    w.sample("uhd_queue_depth", {"model": HOSTILE}, 3, help='queued\nnow "really"')
    text = w.render()
    other = PORT if pkg == JAX else JAX
    ow = PKG[other]["prom"].Writer()
    ow.sample("uhd_queue_depth", {"model": HOSTILE}, 3, help='queued\nnow "really"')
    assert ow.render() == text
    types, helps, samples = PKG[other]["prom"].parse_exposition(text)
    [(name, labels, value)] = samples
    assert labels == {"model": HOSTILE} and value == 3.0
    assert helps["uhd_queue_depth"] == 'queued\nnow "really"'


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_parse_exposition_rejects_duplicates_and_malformed(pkg):
    parse = PKG[pkg]["prom"].parse_exposition
    with pytest.raises(ValueError, match="duplicate TYPE"):
        parse("# TYPE a counter\n# TYPE a gauge\na 1\n")
    with pytest.raises(ValueError, match="duplicate HELP"):
        parse("# HELP a x\n# HELP a y\na 1\n")
    with pytest.raises(ValueError, match="value"):
        parse("a notanumber\n")
    with pytest.raises(ValueError, match="label"):
        parse('a{model="unterminated} 1\n')


def _trace(pkg: str, marks: dict, **kw):
    t = PKG[pkg]["trace"].RequestTrace("req-1", model="m", t_submit=marks["t_submit"], **kw)
    for k, v in marks.items():
        setattr(t, k, v)
    t.step = 4
    return t


@pytest.mark.parametrize("marks", [
    dict(t_submit=10.0, t_dequeue=10.001, t_device_start=10.0015, t_device_end=10.002,
         t_resolve=10.0021, t_write_start=10.003, t_write_end=10.0035),
    dict(t_submit=5.0, t_dequeue=5.5),  # abandoned mid-path: later marks collapse
    dict(t_submit=1.25),
], ids=["full", "dequeued", "submitted"])
def test_request_trace_finalize_equals_jax(marks):
    got = _trace(PORT, marks, replica=1).finalize(error=True)
    want = _trace(JAX, marks, replica=1).finalize(error=True)
    got.pop("ts"), want.pop("ts")  # wall-clock stamps of each call
    assert got == want
    t = _trace(PORT, marks)
    assert t.finalize() is not None and t.finalize() is None  # idempotent


@pytest.mark.parametrize("raw", [None, "", "  abc-1  ", "x" * 128, "x" * 129, "a b", 'a"b',
                                 "{id}", "ok~id", "é"])
def test_adopt_request_id_equals_jax(raw):
    assert ttrace.adopt_request_id(raw) == jtrace.adopt_request_id(raw)


def test_trace_buffer_rings_and_jsonl(tmp_path):
    buf = ttrace.TraceBuffer(4, event_capacity=2, jsonl_path=tmp_path / "t.jsonl")
    for i in range(6):
        buf.append({"kind": "request", "id": f"r{i}", "model": "m"})
    for i in range(3):
        buf.record_event("promotion", model="m", t_mono=float(i), step=i)
    snap = buf.snapshot()
    assert [e["id"] for e in snap if e["kind"] == "request"] == ["r2", "r3", "r4", "r5"]
    assert [e["step"] for e in snap if e["kind"] == "event"] == [1, 2]
    assert [e["seq"] for e in snap] == sorted(e["seq"] for e in snap)
    assert buf.snapshot(request_id="r4")[0]["id"] == "r4"
    buf.close()
    assert len((tmp_path / "t.jsonl").read_text().splitlines()) == 9
    assert ttrace.new_request_id().startswith("req-")


def _window(pkg: str, seed: int):
    rng = np.random.default_rng(seed)
    mod = PKG[pkg]["window"]
    w = mod.MetricsWindow(capacity=5)
    n_req = n_shed = n_obs = n_over = 0
    t = 100.0
    for _ in range(8):  # more than the capacity: the oldest are evicted
        t += float(rng.uniform(0.5, 2.0))
        n_req += int(rng.integers(0, 50))
        n_shed += int(rng.integers(0, 5))
        n_obs += int(rng.integers(1, 50))
        n_over += int(rng.integers(0, 2))
        w.append(mod.WindowSnapshot(t, n_requests=n_req, n_shed=n_shed,
                                    queue_depth=int(rng.integers(0, 20)), n_observed=n_obs,
                                    n_over_slo=n_over))
    return w


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_window_series_equals_jax(seed):
    got, want = _window(PORT, seed), _window(JAX, seed)
    assert got.series() == want.series()
    assert got.span_s == want.span_s and len(got) == len(want) == 5
    with pytest.raises(ValueError, match="not after"):
        got.append(twindow.WindowSnapshot(0.0, n_requests=0, n_shed=0, queue_depth=0))


def test_timed_block_passes_host_values_and_times():
    out = np.arange(3)
    with tprofiler.timed_block("device") as tb:
        assert tb.sync(out) is out
        assert tb.sync((out, [1, 2])) == (out, [1, 2])
    assert tb.elapsed_s >= 0.0


def test_profile_capture_writes_a_trace_and_refuses_a_second(tmp_path):
    out = tprofiler.profile_capture(str(tmp_path / "prof"), 1.0)
    assert out == str(tmp_path / "prof")
    [trace] = (tmp_path / "prof").glob("trace_*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    held = threading.Event()
    release = threading.Event()

    def hold():  # a capture in progress on another thread
        with tprofiler._capture_lock:
            held.set()
            release.wait(30)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(30)
        with pytest.raises(RuntimeError, match="already in progress"):
            tprofiler.profile_capture(str(tmp_path / "again"), 1.0)
    finally:
        release.set()
        t.join(30)
    assert not t.is_alive()
