"""Fleet observability plane: a pull-based aggregator over N serving
endpoints (DESIGN.md §13).

The torch counterpart of ``repro.obs.aggregator``, host code alone: the
scrape state, merge, windows and Prometheus text are the JAX package's,
so one aggregator may scrape servers of either package.

One `FleetAggregator` scrapes a set of targets — in-process registries
(`LocalTarget`) and remote `HdcHttpServer` processes over real sockets
(`HttpTarget`) — on an interval.  Each scrape pulls two things:

  * ``GET /metrics?detail=state`` — the full-fidelity cumulative form
    (`ServingMetrics.state()`: every counter plus exact histogram
    buckets).  The aggregator reconstructs per-target `ServingMetrics`
    with ``from_state`` and merges across targets with the same
    bucket-wise `Histogram.merge` used inside a process, so the fleet
    percentiles are **bit-identical** to a single instance fed every
    observation — never averaged percentiles, never parsed text.
  * ``GET /v1/traces`` — the target's trace ring tail.  Entries merge
    into one fleet-wide ring keyed by request id, deduplicating across
    scrapes (a re-scraped id keeps the **newest** copy), so
    ``/v1/traces?id=`` at the aggregator resolves any replica's
    exemplar fleet-wide, replica attribution intact.

On top of the cumulative merge the aggregator keeps one
`~repro_torch.obs.window.MetricsWindow` per model: every scrape appends a
timestamped cumulative snapshot, and true time series — request rate,
shed rate, queue-depth trajectory and derivative, SLO burn — derive
from first-to-last deltas (see window.py for why that is the only
honest construction).

Failure model: a dead or misbehaving target degrades to **stale**
(its last scrape error and age are reported per target in
``GET /v1/fleet``), its last successful cumulative state stays in the
merge (cumulative counters from a dead process remain true totals of
the work it served), and the surviving targets' merged metrics are
unaffected.  A scrape failure can never crash the plane.

The aggregator serves its merged view through
:class:`AggregatorServer` — the same `AsyncHttpServer` base as the
serving front-end — with the same content negotiation: JSON by
default, Prometheus text exposition (rendered by the same
`repro_torch.obs.prometheus.Writer`) under ``Accept: text/plain``.

Import note: this module sits *above* the transport (it is the one
`repro_torch.obs` member allowed to import `repro_torch.transport`), so
it is NOT imported eagerly by ``repro_torch.obs.__init__`` — import
``repro_torch.obs.aggregator`` explicitly.
"""

from __future__ import annotations

import collections
import threading
import time
from http import HTTPStatus

from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.obs.prometheus import Writer, serving_families
from repro_torch.obs.window import MetricsWindow, WindowSnapshot
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.transport import protocol
from repro_torch.transport.client import HdcClient
from repro_torch.transport.server import AsyncHttpServer, Request, Response


# -- scrape targets ---------------------------------------------------------


class HttpTarget:
    """One remote `HdcHttpServer` scraped over its real socket.

    Not thread-safe (it owns one keep-alive `HdcClient`) — scraped only
    from the aggregator's scrape thread, like every target.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        name: str | None = None,
        timeout_s: float = 5.0,
        trace_n: int = 512,
    ):
        self.name = name or f"{host}:{port}"
        self.trace_n = int(trace_n)
        self._client = HdcClient(host, port, timeout_s=timeout_s)

    def scrape(self) -> dict:
        """One pull: ``{"metrics": {model: state}, "traces": [entry]}``.
        Any socket/HTTP/decode failure raises — the aggregator turns it
        into per-target staleness, never a crash."""
        return {
            "metrics": self._client.metrics_state(),
            "traces": self._client.traces(n=self.trace_n),
        }

    def close(self) -> None:
        self._client.close()


class LocalTarget:
    """An in-process `ModelRegistry` (e.g. the pool this process also
    serves) scraped through the same `metrics_state()` code path as the
    HTTP form — local and remote aggregation can never skew."""

    def __init__(self, registry, *, name: str = "local", trace_n: int = 512):
        self.name = name
        self.trace_n = int(trace_n)
        self._registry = registry

    def scrape(self) -> dict:
        return {
            "metrics": self._registry.metrics_state(),
            "traces": self._registry.traces.snapshot(self.trace_n),
        }

    def close(self) -> None:
        pass


# -- per-target bookkeeping -------------------------------------------------


class TargetState:
    """Scrape health + last successful cumulative state for one target."""

    def __init__(self, name: str):
        self.name = name
        self.n_scrapes = 0  # successful scrapes
        self.n_errors = 0
        self.last_ok_t: float | None = None  # perf_counter of last success
        self.last_error: str | None = None
        self.metrics: dict | None = None  # last successful metrics_state
        # wall time of each scrape attempt (success AND failure — a
        # slow-then-dead target's timeouts belong in its tail), served
        # as `uhd_fleet_scrape_seconds{target=}`
        self.scrape_seconds = LatencyHistogram()

    def describe(self, *, now: float, stale_after_s: float) -> dict:
        age = None if self.last_ok_t is None else now - self.last_ok_t
        return {
            "name": self.name,
            "n_scrapes": int(self.n_scrapes),
            "n_errors": int(self.n_errors),
            "last_scrape_age_s": age,
            "stale": age is None or age > stale_after_s,
            "last_error": self.last_error,
            "scrape_p50_ms": (
                self.scrape_seconds.percentile(50) * 1e3
                if self.scrape_seconds.count else None
            ),
            "scrape_p99_ms": (
                self.scrape_seconds.percentile(99) * 1e3
                if self.scrape_seconds.count else None
            ),
            "models": sorted(self.metrics) if self.metrics else [],
        }


# -- the aggregation plane --------------------------------------------------


class FleetAggregator:
    """Interval scraper + exact merger + windowed time series.

    ``scrape_once()`` is the whole cycle (tests drive it directly;
    ``start()`` runs it on a daemon thread every ``interval_s``).  All
    read APIs (`merged_metrics`, `fleet`, `traces`, `trace_by_id`) are
    thread-safe against the scrape thread.
    """

    def __init__(
        self,
        targets,
        *,
        interval_s: float = 1.0,
        stale_after_s: float | None = None,
        trace_capacity: int = 4096,
        window_capacity: int = 256,
        slo_ms: float | None = 50.0,
    ):
        self.targets = list(targets)
        names = [t.name for t in self.targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate target names: {names}")
        self.interval_s = float(interval_s)
        # a target is stale once its last success is older than this;
        # 3 missed scrapes is the conventional federation threshold
        self.stale_after_s = (
            3.0 * self.interval_s if stale_after_s is None else float(stale_after_s)
        )
        self.trace_capacity = int(trace_capacity)
        self.window_capacity = int(window_capacity)
        self.slo_ms = slo_ms
        self._lock = threading.RLock()
        self._states = {t.name: TargetState(t.name) for t in self.targets}
        # fleet trace ring: dedup key -> entry, insertion-ordered so the
        # oldest key evicts first; re-ingesting a key moves it to the
        # end with the NEWEST copy (a re-scraped ring tail refreshes)
        self._traces: collections.OrderedDict[tuple, dict] = (
            collections.OrderedDict()
        )
        self._windows: dict[str, MetricsWindow] = {}
        self.n_cycles = 0
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetAggregator":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._run, name="hdc-obs-aggregator", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_event.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join()
        for t in self.targets:
            t.close()

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop_event.is_set():
            t0 = time.perf_counter()
            try:
                self.scrape_once()
            except Exception:  # the plane survives anything a cycle throws
                pass
            rest = self.interval_s - (time.perf_counter() - t0)
            if rest > 0:
                self._stop_event.wait(rest)

    # -- the scrape cycle --------------------------------------------------

    def scrape_once(self) -> dict:
        """One full cycle: pull every target, ingest, append windows.

        Returns a per-target ok/error summary (the smoke driver prints
        it).  A failing target records its error and goes stale; it
        never raises out of the cycle.
        """
        summary = {}
        for target in self.targets:
            state = self._states[target.name]
            t0 = time.perf_counter()
            try:
                pulled = target.scrape()
                metrics = dict(pulled.get("metrics") or {})
                # validate before committing: a half-garbled scrape must
                # not replace the last good state
                for name, entry in metrics.items():
                    ServingMetrics.from_state(entry["serving"])
            except Exception as e:
                with self._lock:
                    state.n_errors += 1
                    state.last_error = f"{type(e).__name__}: {e}"
                    state.scrape_seconds.observe(time.perf_counter() - t0)
                summary[target.name] = {"ok": False, "error": state.last_error}
                continue
            with self._lock:
                state.n_scrapes += 1
                state.last_ok_t = time.perf_counter()
                state.last_error = None
                state.metrics = metrics
                state.scrape_seconds.observe(state.last_ok_t - t0)
                self._ingest_traces(target.name, pulled.get("traces") or ())
            summary[target.name] = {"ok": True, "models": sorted(metrics)}
        self._append_windows()
        with self._lock:
            self.n_cycles += 1
        return summary

    def _ingest_traces(self, target_name: str, entries) -> None:
        """Merge one target's ring tail (caller holds the lock).

        Requests dedup fleet-wide by id (an id is process-unique and
        adopted across hops, so the same id seen again — from a re-scrape
        or from another hop's ring — keeps the newest copy); events have
        no id and dedup per-target by their ring seq."""
        for entry in entries:
            if not isinstance(entry, dict):
                continue
            rid = entry.get("id")
            if rid is not None:
                key = ("request", str(rid))
            else:
                key = ("event", target_name, entry.get("seq"))
            self._traces.pop(key, None)  # refresh: newest copy, newest slot
            self._traces[key] = {**entry, "target": target_name}
        while len(self._traces) > self.trace_capacity:
            self._traces.popitem(last=False)

    def _append_windows(self) -> None:
        """Append this cycle's fleet-merged cumulative values to each
        model's window.  Timestamps must strictly increase; a same-tick
        double cycle skips the append rather than corrupting the axis."""
        merged = self.merged_metrics()
        now = time.perf_counter()
        slo_s = None if self.slo_ms is None else self.slo_ms / 1e3
        with self._lock:
            for name, m in merged.items():
                window = self._windows.get(name)
                if window is None:
                    window = self._windows[name] = MetricsWindow(
                        self.window_capacity
                    )
                snap = WindowSnapshot(
                    now,
                    n_requests=m.n_requests,
                    n_shed=m.n_shed,
                    queue_depth=m.queue_depth,
                    n_observed=m.latency.count,
                    n_over_slo=(
                        m.latency.count_over(slo_s) if slo_s is not None else 0
                    ),
                )
                try:
                    window.append(snap)
                except ValueError:
                    pass  # non-increasing tick: drop this sample, not the axis

    # -- merged reads ------------------------------------------------------

    def merged_metrics(self) -> dict[str, ServingMetrics]:
        """model -> fleet-merged `ServingMetrics` over every target's
        last successful scrape: ``from_state`` + `merge`, i.e. summed
        buckets — bit-identical to merging the live instances."""
        with self._lock:
            states = [
                (s.name, s.metrics) for s in self._states.values() if s.metrics
            ]
        out: dict[str, ServingMetrics] = {}
        for _, metrics in states:
            for name, entry in metrics.items():
                m = ServingMetrics.from_state(entry["serving"])
                out[name] = out[name].merge(m) if name in out else m
        return out

    def merged_online_metrics(self) -> dict[str, ServingMetrics]:
        """model -> fleet-merged online-learning stage metrics (only for
        targets/models that run an `OnlineLearner`)."""
        with self._lock:
            states = [s.metrics for s in self._states.values() if s.metrics]
        out: dict[str, ServingMetrics] = {}
        for metrics in states:
            for name, entry in metrics.items():
                state = entry.get("online_metrics")
                if state is None:
                    continue
                m = ServingMetrics.from_state(state)
                out[name] = out[name].merge(m) if name in out else m
        return out

    def scrape_latencies(self) -> dict[str, LatencyHistogram]:
        """target name -> its scrape-latency histogram (every attempt,
        success or failure) — the plane watching its own pull cost."""
        with self._lock:
            return {s.name: s.scrape_seconds for s in self._states.values()}

    def merged_state(self) -> dict[str, dict]:
        """The merged view in scrape-state form (exact buckets) — what a
        second-tier aggregator would scrape; also the form tests compare
        bit-for-bit against a manual `Histogram.merge`."""
        return {
            name: {"serving": m.state()}
            for name, m in self.merged_metrics().items()
        }

    def windows(self) -> dict[str, dict]:
        """model -> derived time series (`MetricsWindow.series()`)."""
        with self._lock:
            return {name: w.series() for name, w in self._windows.items()}

    def traces(
        self,
        n: int | None = None,
        *,
        kind: str | None = None,
        model: str | None = None,
        request_id: str | None = None,
    ) -> list[dict]:
        """Fleet-merged trace entries, oldest first, same filters as the
        per-process ring."""
        with self._lock:
            entries = list(self._traces.values())
        if kind is not None:
            entries = [e for e in entries if e.get("kind") == kind]
        if model is not None:
            entries = [e for e in entries if e.get("model") == model]
        if request_id is not None:
            entries = [e for e in entries if e.get("id") == request_id]
        if n is not None and n >= 0:
            entries = entries[-n:]
        return entries

    def trace_by_id(self, request_id: str) -> dict | None:
        with self._lock:
            return self._traces.get(("request", str(request_id)))

    def fleet(self) -> dict:
        """The ``GET /v1/fleet`` body: per-target scrape health (age,
        staleness, last error), the per-model windowed series, and the
        plane's own config."""
        now = time.perf_counter()
        with self._lock:
            targets = [
                s.describe(now=now, stale_after_s=self.stale_after_s)
                for s in self._states.values()
            ]
            n_traces = len(self._traces)
            n_cycles = self.n_cycles
        return {
            "interval_s": self.interval_s,
            "stale_after_s": self.stale_after_s,
            "slo_ms": self.slo_ms,
            "n_cycles": int(n_cycles),
            "n_targets": len(targets),
            "n_stale": sum(1 for t in targets if t["stale"]),
            "n_traces": int(n_traces),
            "targets": targets,
            "windows": self.windows(),
        }


# -- Prometheus rendering ---------------------------------------------------


def render_fleet_prometheus(agg: FleetAggregator) -> str:
    """Merged-fleet text exposition through the same `Writer` as a
    single process — a dashboard cannot tell the two apart — plus the
    plane's own ``uhd_fleet_*`` families (target/staleness gauges and
    the window-derived rates)."""
    w = Writer()
    for name, m in agg.merged_metrics().items():
        serving_families(w, {"model": name}, m)
    for name, m in agg.merged_online_metrics().items():
        w.histogram(
            "uhd_online_feedback_to_publish_seconds", {"model": name},
            m.latency,
            help="oldest-feedback-to-checkpoint-publish latency per "
                 "publish cycle",
        )
        for stage, hist in m.stage.items():
            w.histogram(
                "uhd_online_stage_latency_seconds",
                {"model": name, "stage": stage}, hist,
                help="per-stage online-learning latency",
            )
    fleet = agg.fleet()
    w.sample("uhd_fleet_targets", {}, fleet["n_targets"],
             help="scrape targets configured")
    w.sample("uhd_fleet_targets_stale", {}, fleet["n_stale"],
             help="targets past the staleness threshold")
    w.sample("uhd_fleet_scrape_cycles_total", {}, fleet["n_cycles"],
             mtype="counter", help="completed scrape cycles")
    for t in fleet["targets"]:
        w.sample("uhd_fleet_target_up", {"target": t["name"]},
                 0 if t["stale"] else 1,
                 help="1 if the target's last scrape is fresh")
        w.sample("uhd_fleet_target_scrape_errors_total", {"target": t["name"]},
                 t["n_errors"], mtype="counter",
                 help="failed scrapes per target")
    for name, hist in agg.scrape_latencies().items():
        if hist.count:
            w.histogram(
                "uhd_fleet_scrape_seconds", {"target": name}, hist,
                help="wall time per scrape attempt (success or failure) "
                     "per target",
            )
    for name, series in fleet["windows"].items():
        labels = {"model": name}
        w.sample("uhd_fleet_request_rate_rps", labels,
                 series["request_rate_rps"],
                 help="windowed request rate (first-to-last delta)")
        w.sample("uhd_fleet_shed_rate_rps", labels, series["shed_rate_rps"],
                 help="windowed shed rate")
        w.sample("uhd_fleet_queue_depth_dps", labels,
                 series["queue_depth_dps"],
                 help="queue-depth derivative, requests/s "
                      "(positive: falling behind)")
        w.sample("uhd_fleet_slo_burn", labels, series["slo_burn"],
                 help="fraction of window observations over the latency "
                      "objective")
    return w.render()


# -- the HTTP frontend ------------------------------------------------------


class AggregatorServer(AsyncHttpServer):
    """The plane's own endpoint, on the shared `AsyncHttpServer` base.

    Routes: ``GET /metrics`` (merged JSON; Prometheus under ``Accept:
    text/plain``; ``?detail=state`` for the exact-bucket merged form),
    ``GET /v1/traces`` (fleet-merged ring, ``?id=`` resolving any
    replica's exemplar — 404 with a JSON body on a miss), ``GET
    /v1/fleet`` (per-target freshness + windows), ``GET /healthz``.
    """

    def __init__(
        self,
        aggregator: FleetAggregator,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_body_bytes: int = 1 << 20,
        request_timeout_s: float = 30.0,
    ):
        super().__init__(
            host=host, port=port, max_body_bytes=max_body_bytes,
            request_timeout_s=request_timeout_s, thread_name="hdc-obs-agg-loop",
        )
        self.aggregator = aggregator

    async def _route(self, request: Request) -> Response:
        method, path = request.method.upper(), request.path
        if method != "GET":
            return Response.error(
                HTTPStatus.METHOD_NOT_ALLOWED,
                "the aggregation plane is read-only (GET)",
            )
        if path == protocol.ROUTE_HEALTH:
            fleet = self.aggregator.fleet()
            return Response.json(HTTPStatus.OK, {
                "status": "ok",
                "n_targets": fleet["n_targets"],
                "n_stale": fleet["n_stale"],
                "n_cycles": fleet["n_cycles"],
            })
        if path == protocol.ROUTE_METRICS:
            return self._metrics(request)
        if path == protocol.ROUTE_TRACES:
            return self._traces(request)
        if path == protocol.ROUTE_FLEET:
            return Response.json(HTTPStatus.OK, self.aggregator.fleet())
        return Response.error(HTTPStatus.NOT_FOUND, f"no route {method} {path}")

    def _metrics(self, request: Request) -> Response:
        if request.query.get("detail") == protocol.METRICS_DETAIL_STATE:
            return Response.json(HTTPStatus.OK, self.aggregator.merged_state())
        if "text/plain" in request.header("accept", "").lower():
            return Response(
                HTTPStatus.OK,
                render_fleet_prometheus(self.aggregator).encode(),
                protocol.CT_PROM,
            )
        windows = self.aggregator.windows()
        out = {}
        for name, m in self.aggregator.merged_metrics().items():
            snap = m.snapshot()
            snap["window"] = windows.get(name)
            out[name] = snap
        return Response.json(HTTPStatus.OK, out)

    def _traces(self, request: Request) -> Response:
        request_id = request.query.get("id")
        if request_id is not None:
            entry = self.aggregator.trace_by_id(request_id)
            if entry is None:
                return Response.error(
                    HTTPStatus.NOT_FOUND,
                    f"no trace with id {request_id!r} across "
                    f"{len(self.aggregator.targets)} targets",
                    id=request_id,
                )
            return Response.json(HTTPStatus.OK, {"traces": [entry]})
        try:
            n = int(request.query["n"]) if "n" in request.query else None
        except ValueError:
            return Response.error(
                HTTPStatus.BAD_REQUEST,
                f"n must be an integer, got {request.query['n']!r}",
            )
        kind = request.query.get("kind")
        if kind is not None and kind not in ("request", "event"):
            return Response.error(
                HTTPStatus.BAD_REQUEST,
                f'kind must be "request" or "event", got {kind!r}',
            )
        entries = self.aggregator.traces(
            n, kind=kind, model=request.query.get("model")
        )
        return Response.json(HTTPStatus.OK, {"traces": entries})
