"""The port's fleet aggregator (``repro_torch.obs.aggregator``,
``launch.obs_agg``) against the JAX package's.

The same scripted scrapes feed an aggregator of each package under one
fake clock, and every view (merged states, windows, the fleet body, the
trace ring, the Prometheus text) must be equal.  The port's own tests
then cover dedup, staleness, garbled scrapes, bucket-layout refusal,
the `AggregatorServer` routes over a real socket, a local against an
HTTP scrape of a live port server, and ``obs_agg --smoke --device cpu``.
No test sets a wall-clock bound; every wait polls with a timeout and
every server, registry and aggregator is stopped in a fixture.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import repro_torch.obs.aggregator as tagg
from repro_torch.core import HDCConfig, HDCModel
from repro_torch.launch import obs_agg as tobs_agg
from repro_torch.obs import LatencyHistogram
from repro_torch.obs.aggregator import (
    AggregatorServer,
    FleetAggregator,
    HttpTarget,
    LocalTarget,
    render_fleet_prometheus,
)
from repro_torch.obs.histogram import log_bounds
from repro_torch.obs.prometheus import parse_exposition
from repro_torch.serving import ModelRegistry, ServingEngine
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.transport import HdcClient, HdcHttpServer, TransportError

jagg = pytest.importorskip("repro.obs.aggregator")

RNG = np.random.default_rng(94)


def _wait(cond, timeout_s: float = 60.0, poll_s: float = 0.005) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met within the timeout")
        time.sleep(poll_s)


def _serving_state(*, n_requests=0, n_shed=0, queue_depth=0, latencies=(), stages=()):
    """A valid `ServingMetrics.state()` payload for scripted targets."""
    m = ServingMetrics()
    for s in latencies:
        m.latency.observe(s)
    for stage, s in stages:
        m.observe_stage(stage, s)
    m.n_requests = n_requests
    m.n_shed = n_shed
    m.queue_depth = queue_depth
    return m.state()


def _online_state(seconds):
    m = ServingMetrics()
    for s in ("ingest", "train", "publish"):
        m.stage.setdefault(s, LatencyHistogram())
    for stage, s in seconds:
        m.observe_stage(stage, s)
    m.latency.observe(sum(s for _, s in seconds))
    return m.state()


class _ScriptedTarget:
    """Scrape target replaying canned payloads (the last one repeats);
    an Exception entry raises — the dead/garbled-target simulator."""

    def __init__(self, name, scrapes):
        self.name = name
        self._scrapes = list(scrapes)

    def scrape(self):
        item = self._scrapes.pop(0) if len(self._scrapes) > 1 else self._scrapes[0]
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        pass


class _Clock:
    """Deterministic stand-in for the `time` module of an aggregator: each
    perf_counter() call advances `step` seconds (0 holds the clock still)."""

    def __init__(self, step: float = 0.125):
        self.t = 1000.0
        self.step = step

    def perf_counter(self):
        self.t += self.step
        return self.t

    def sleep(self, s):
        pass


def _scrapes(scenario: str) -> dict[str, list]:
    """Target name -> its scripted scrapes, per scenario."""
    rng = np.random.default_rng(7)  # the same data for either package
    lat = [float(x) for x in rng.uniform(1e-4, 0.2, 40)]
    st = [(s, float(x)) for s, x in zip(("queue", "device", "write") * 5,
                                         rng.uniform(1e-5, 0.01, 15))]

    def ok(n, **kw):
        return {"metrics": {"m": {"serving": _serving_state(n_requests=n, **kw)}},
                "traces": [{"id": f"req-{n}", "kind": "request", "model": "m",
                            "e2e_ms": float(n)}]}

    if scenario == "two_live":
        return {"a": [ok(n, latencies=lat[:n], stages=st) for n in (4, 9, 20)],
                "b": [ok(n, latencies=lat[20:20 + n], n_shed=1) for n in (2, 6, 11)]}
    if scenario == "one_dead":
        return {"live": [ok(n, latencies=lat[:n]) for n in (3, 8, 13)],
                "dead": [ok(5, latencies=lat[30:35]), ConnectionRefusedError("boom")]}
    if scenario == "garbled":
        good = _serving_state(n_requests=3, latencies=lat[:3])
        garbled = dict(good, latency=dict(good["latency"], count=999))
        return {"t": [{"metrics": {"m": {"serving": good}}, "traces": []},
                      {"metrics": {"m": {"serving": garbled}}, "traces": []}]}
    if scenario == "online":
        entry = {"serving": _serving_state(n_requests=6, latencies=lat[:6]),
                 "online_metrics": _online_state(
                     [("ingest", 0.002), ("train", 0.03), ("publish", 0.1)])}
        events = [{"kind": "event", "seq": i, "event": "publish", "model": "m"}
                  for i in range(3)]
        return {"t0": [{"metrics": {"m": entry}, "traces": events}],
                "t1": [{"metrics": {"m": entry, "n": {"serving": _serving_state(
                    n_requests=2, latencies=lat[6:8])}}, "traces": events[:1]}]}
    raise KeyError(scenario)


def _views(mod, monkeypatch, scenario: str) -> dict:
    monkeypatch.setattr(mod, "time", _Clock())
    targets = [_ScriptedTarget(name, s) for name, s in _scrapes(scenario).items()]
    agg = mod.FleetAggregator(targets, interval_s=0.5, trace_capacity=4, slo_ms=50.0)
    summaries = [agg.scrape_once() for _ in range(4)]
    return {
        "summaries": summaries,
        "merged_state": agg.merged_state(),
        "online": {n: m.state() for n, m in agg.merged_online_metrics().items()},
        "windows": agg.windows(),
        "fleet": agg.fleet(),
        "traces": agg.traces(),
        "prometheus": mod.render_fleet_prometheus(agg),
    }


@pytest.mark.parametrize("scenario", ["two_live", "one_dead", "garbled", "online"])
def test_fleet_views_equal_jax_for_the_same_scrapes(monkeypatch, scenario):
    """The same scrapes under the same clock: every view of the port's
    aggregator equals the JAX package's, the Prometheus text byte for byte."""
    want = _views(jagg, monkeypatch, scenario)
    got = _views(tagg, monkeypatch, scenario)
    for key in want:
        assert got[key] == want[key], key
    parse_exposition(got["prometheus"])  # strict: HELP/TYPE once per family


# ---------------------------------------------------------------------------
# dedup, staleness, garbled scrapes, bucket layouts
# ---------------------------------------------------------------------------


def test_trace_dedup_keeps_newest_copy():
    metrics = {"m": {"serving": _serving_state(n_requests=1)}}
    old = {"id": "req-1", "kind": "request", "model": "m", "e2e_ms": 1.0}
    new = {"id": "req-1", "kind": "request", "model": "m", "e2e_ms": 9.0}
    target = _ScriptedTarget("t", [{"metrics": metrics, "traces": [old]},
                                   {"metrics": metrics, "traces": [new]}])
    agg = FleetAggregator([target], interval_s=0.01)
    agg.scrape_once()
    agg.scrape_once()
    (entry,) = agg.traces(kind="request")
    assert entry["e2e_ms"] == 9.0 and entry["target"] == "t"


def test_trace_events_dedup_per_target_and_ring_is_bounded():
    metrics = {"m": {"serving": _serving_state()}}

    def ev(seq):
        return {"kind": "event", "seq": seq, "event": "promote"}

    a = _ScriptedTarget("a", [{"metrics": metrics, "traces": [ev(0), ev(1)]}])
    b = _ScriptedTarget("b", [{"metrics": metrics, "traces": [ev(0)]}])
    agg = FleetAggregator([a, b], interval_s=0.01, trace_capacity=2)
    agg.scrape_once()
    agg.scrape_once()
    entries = agg.traces(kind="event")
    assert len(entries) == 2
    assert {e["target"] for e in entries} == {"a", "b"}


def test_duplicate_target_names_rejected():
    t = _ScriptedTarget("x", [{"metrics": {}, "traces": []}])
    u = _ScriptedTarget("x", [{"metrics": {}, "traces": []}])
    with pytest.raises(ValueError, match="duplicate target names"):
        FleetAggregator([t, u])


def test_dead_target_goes_stale_survivors_unaffected(monkeypatch):
    monkeypatch.setattr(tagg, "time", _Clock())  # ages in clock ticks, not sleeps
    ok = {"metrics": {"m": {"serving": _serving_state(n_requests=7)}}, "traces": []}
    live = _ScriptedTarget("live", [ok])
    dead = _ScriptedTarget("dead", [
        {"metrics": {"m": {"serving": _serving_state(n_requests=5)}}, "traces": []},
        ConnectionRefusedError("boom"),
    ])
    agg = FleetAggregator([live, dead], interval_s=0.01, stale_after_s=0.6)
    agg.scrape_once()
    assert agg.fleet()["n_stale"] == 0
    summary = agg.scrape_once()
    assert summary["dead"]["ok"] is False
    assert "ConnectionRefusedError" in summary["dead"]["error"]
    by_name = {t["name"]: t for t in agg.fleet()["targets"]}
    assert by_name["dead"]["stale"] and not by_name["live"]["stale"]
    assert by_name["dead"]["last_error"] and by_name["live"]["last_error"] is None
    assert agg.merged_metrics()["m"].n_requests == 7 + 5


def test_garbled_scrape_never_replaces_last_good_state():
    good = _serving_state(n_requests=3, latencies=[0.01, 0.02])
    garbled = dict(good, latency=dict(good["latency"], count=999))
    target = _ScriptedTarget("t", [
        {"metrics": {"m": {"serving": good}}, "traces": []},
        {"metrics": {"m": {"serving": garbled}}, "traces": []},
    ])
    agg = FleetAggregator([target], interval_s=0.01)
    agg.scrape_once()
    summary = agg.scrape_once()
    assert summary["t"]["ok"] is False and "999" in summary["t"]["error"]
    assert agg.merged_state()["m"]["serving"] == good
    state = agg.fleet()["targets"][0]
    assert state["n_errors"] == 1 and state["n_scrapes"] == 1


def test_mismatched_bucket_layouts_refuse_to_merge():
    a = LatencyHistogram()
    b = LatencyHistogram(log_bounds(1e-3, 1.0, per_decade=4))
    with pytest.raises(ValueError, match="different bucket bounds"):
        a.merge(b)
    state = a.state()
    state["counts"] = state["counts"][:-1]
    with pytest.raises(ValueError, match="counts"):
        LatencyHistogram.from_state(state)
    state = a.state()
    state["count"] = 12
    with pytest.raises(ValueError, match="bucket sum"):
        LatencyHistogram.from_state(state)
    with pytest.raises(ValueError, match="malformed"):
        ServingMetrics.from_state({"nope": 1})
    # two targets on two layouts: the cycle's merge refuses loudly (the
    # scrape thread survives it; see FleetAggregator._run)
    odd = ServingMetrics()
    odd.latency = b
    target = _ScriptedTarget("t", [
        {"metrics": {"m": {"serving": _serving_state(n_requests=1)}}, "traces": []},
    ])
    other = _ScriptedTarget("u", [{"metrics": {"m": {"serving": odd.state()}}, "traces": []}])
    agg = FleetAggregator([target, other], interval_s=0.01)
    with pytest.raises(ValueError, match="different bucket bounds"):
        agg.scrape_once()


# ---------------------------------------------------------------------------
# live sockets
# ---------------------------------------------------------------------------


@pytest.fixture
def owned():
    """Servers, aggregators, clients and registries, stopped at the end in
    that order whatever the test did."""
    objs: list = []
    yield objs.append
    for kind in (HdcClient, AggregatorServer, HdcHttpServer, FleetAggregator, ModelRegistry):
        for obj in objs:
            if isinstance(obj, kind):
                if isinstance(obj, HdcClient):
                    obj.close()
                elif isinstance(obj, ModelRegistry):
                    obj.shutdown(drain=False)
                else:
                    obj.stop()


def _serve(owned, replicas=1):
    cfg = HDCConfig(n_features=24, n_classes=4, d=128, levels=16, similarity="hamming")
    x = RNG.uniform(0, 255, (32, cfg.n_features)).astype(np.float32)
    y = RNG.integers(0, cfg.n_classes, 32).astype(np.int32)
    model = HDCModel.create(cfg, device="cpu").fit(x, y)
    registry = ModelRegistry()
    owned(registry)
    engines = [ServingEngine(model, batch_size=8, device="cpu") for _ in range(replicas)]
    if replicas == 1:
        batcher = registry.register("m", engines[0], start=True, max_delay_ms=0.5)
    else:
        batcher = registry.register_pool("m", engines, start=True, max_delay_ms=0.5)
    server = HdcHttpServer(registry).start()
    owned(server)
    client = HdcClient(*server.address)
    owned(client)
    return cfg, registry, batcher, server, client


def test_local_and_http_targets_scrape_identically(owned):
    """A LocalTarget over the registry and an HttpTarget over its server
    pull the same state — once the server's ``write`` stage has counted
    every request (``on_written`` runs after the client has its bytes,
    so the scrape waits for it instead of racing it)."""
    cfg, registry, batcher, server, client = _serve(owned)
    client.predict_batch("m", RNG.uniform(0, 255, (10, cfg.n_features)))
    _wait(lambda: batcher.metrics.stage["write"].count == 10)
    local = LocalTarget(registry).scrape()
    remote = HttpTarget(*server.address)
    try:
        got = remote.scrape()
    finally:
        remote.close()
    assert local["metrics"] == got["metrics"]
    assert [t["id"] for t in local["traces"] if t.get("id")] == [
        t["id"] for t in got["traces"] if t.get("id")
    ]


def test_merged_state_and_cross_hop_id_over_live_port_servers(owned):
    """A port pool and a port single engine behind sockets: the merged
    state equals a manual merge of their scrapes, and a client-minted id
    resolves at the aggregator with the replica that served it."""
    cfg, _, pool, server_a, client_a = _serve(owned, replicas=2)
    _, _, single, server_b, client_b = _serve(owned)
    images = RNG.uniform(0, 255, (12, cfg.n_features)).astype(np.float32)
    client_a.predict_batch("m", images)
    client_b.predict_batch("m", images[:5])
    client_a.predict("m", images[0], request_id="req-tracked")
    _wait(lambda: pool.merged_metrics().stage["write"].count == 13
          and single.metrics.stage["write"].count == 5)
    agg = FleetAggregator([HttpTarget(*server_a.address, name="pool"),
                           HttpTarget(*server_b.address, name="single")], interval_s=0.1)
    owned(agg)
    summary = agg.scrape_once()
    assert all(v["ok"] for v in summary.values()), summary
    manual = ServingMetrics.from_state(client_a.metrics_state()["m"]["serving"]).merge(
        ServingMetrics.from_state(client_b.metrics_state()["m"]["serving"]))
    assert agg.merged_state()["m"]["serving"] == manual.state()
    assert agg.merged_metrics()["m"].latency.count == 12 + 5 + 1
    entry = agg.trace_by_id("req-tracked")
    assert entry["target"] == "pool" and entry["replica"] in (0, 1)
    assert set(entry["spans"]) == {"queue_ms", "assembly_ms", "device_ms", "write_ms"}


def test_aggregator_server_routes_end_to_end(owned):
    hostile = 'fleet"model\\with\nnewline'
    target = _ScriptedTarget("t", [{
        "metrics": {hostile: {"serving": _serving_state(
            n_requests=4, latencies=[0.001, 0.002, 0.004, 0.008])}},
        "traces": [{"id": "req-hit", "kind": "request", "model": hostile, "e2e_ms": 1.0}],
    }])
    agg = FleetAggregator([target], interval_s=0.01)
    owned(agg)
    agg.scrape_once()
    server = AggregatorServer(agg).start()
    owned(server)
    client = HdcClient(*server.address)
    owned(client)
    health = client.healthz()
    assert health["status"] == "ok" and health["n_targets"] == 1
    snap = client.metrics()[hostile]
    assert snap["n_requests"] == 4 and "window" in snap
    assert client.metrics_state() == agg.merged_state()
    (entry,) = client.traces(request_id="req-hit")
    assert entry["id"] == "req-hit" and entry["target"] == "t"
    with pytest.raises(TransportError) as exc:
        client.traces(request_id="req-miss")
    assert exc.value.status == 404 and "req-miss" in str(exc.value)
    fleet = client._json("GET", "/v1/fleet")
    assert fleet["n_targets"] == 1 and fleet["n_traces"] == 1
    assert fleet["targets"][0]["models"] == [hostile]
    types_, _, samples = parse_exposition(client.metrics(prometheus=True))
    assert types_["uhd_requests_total"] == "counter"
    assert {"model": hostile} in [ls for n, ls, _ in samples if n == "uhd_requests_total"]
    for method, path, status in [("POST", "/metrics", 405), ("GET", "/v1/traces?kind=bogus", 400),
                                 ("GET", "/v1/traces?n=x", 400), ("GET", "/nope", 404)]:
        with pytest.raises(TransportError) as exc:
            client._json(method, path, b"{}" if method == "POST" else None)
        assert exc.value.status == status, (method, path)


def test_fleet_prometheus_families_render(monkeypatch):
    # the clock stands still between the scrape and the render: no wall
    # time under load can age the target past its 30 ms staleness window
    monkeypatch.setattr(tagg, "time", _Clock(step=0.0))
    target = _ScriptedTarget("t", [{
        "metrics": {"m": {
            "serving": _serving_state(n_requests=2, latencies=[0.01, 0.02]),
            "online_metrics": _online_state([("train", 0.01)]),
        }},
        "traces": [],
    }])
    agg = FleetAggregator([target], interval_s=0.01)
    agg.scrape_once()
    types_, _, samples = parse_exposition(render_fleet_prometheus(agg))
    names = {n for n, _, _ in samples}
    assert {"uhd_fleet_target_up", "uhd_fleet_scrape_cycles_total"} <= names
    assert types_["uhd_online_stage_latency_seconds"] == "histogram"
    assert [v for n, ls, v in samples
            if n == "uhd_fleet_target_up" and ls == {"target": "t"}] == [1.0]


def test_background_scrape_thread_lifecycle(owned):
    target = _ScriptedTarget("t", [
        {"metrics": {"m": {"serving": _serving_state(n_requests=1)}}, "traces": []},
    ])
    agg = FleetAggregator([target], interval_s=0.01).start()
    owned(agg)
    assert agg.running()
    _wait(lambda: agg.fleet()["n_cycles"] >= 3)
    agg.stop()
    assert not agg.running()
    cycles = agg.fleet()["n_cycles"]
    time.sleep(0.05)
    assert agg.fleet()["n_cycles"] == cycles


def test_aggregator_is_not_imported_by_the_obs_package():
    code = ("import sys, repro_torch.obs, repro_torch.serving\n"
            "assert 'repro_torch.obs.aggregator' not in sys.modules\n"
            "assert 'repro_torch.transport' not in sys.modules\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr


def test_obs_agg_smoke_on_the_cpu(capsys):
    args = ["--smoke", "--device", "cpu", "--d", "256", "--n-train", "128",
            "--requests", "48", "--batch", "16", "--interval", "0.05"]
    assert tobs_agg.main(args) == 0
    out = capsys.readouterr().out
    assert "bit-identical to manual state merge" in out
    assert "cross-hop trace OK" in out and "degraded cleanly" in out
    assert out.rstrip().endswith("smoke OK")
