"""Serving-side observability: request latency, throughput, queue depth.

The port's copy of ``repro.serving.metrics``: ``state()`` and
``from_state()`` are JSON-compatible with the JAX package's in both
directions.

One `ServingMetrics` instance rides with each micro-batcher.  All
mutators are thread-safe (the drain thread and submitter threads update
concurrently).  Latencies live in fixed-bucket log-spaced
:class:`~repro_torch.obs.LatencyHistogram`\\ s — constant memory, exact
counts, and mergeable across instances — one for end-to-end latency and
one per pipeline stage (queue / assembly / device / write).
`snapshot()` is the main read API — a plain strict-JSON dict (absent
values are None, never NaN) suitable for logging, the smoke CLI, the
`/metrics` endpoint, and the benchmark artifacts.
"""

from __future__ import annotations

import threading
import time

from repro_torch.obs.histogram import LatencyHistogram

#: pipeline stages every request crosses, in order
STAGES = ("queue", "assembly", "device", "write")


class ServingMetrics:
    """Counters + per-stage latency histograms for one serving queue."""

    def __init__(self, window: int = 16384):
        # `window` is kept for API compatibility with the old bounded
        # reservoir; histograms are constant-memory so it is unused.
        self.window = int(window)
        self._lock = threading.Lock()
        self.latency = LatencyHistogram()  # end-to-end submit→resolve
        self.stage = {s: LatencyHistogram() for s in STAGES}
        self._t0 = time.perf_counter()
        self._t_first: float | None = None  # first/last request completion:
        self._t_last: float | None = None  # throughput excludes idle time
        self.n_requests = 0  # requests completed
        self.n_batches = 0  # device batches launched
        self.n_slots = 0  # total slots across launched batches
        self.n_padded = 0  # slots that carried padding, not a request
        self.n_errors = 0  # requests failed with an exception
        self.n_reloads = 0  # hot engine swaps observed
        self.n_shed = 0  # admission-rejected under overload (HTTP 429)
        self.n_rejected = 0  # rejected for non-load reasons (stopped batcher)
        self.queue_depth = 0  # requests currently waiting (gauge)
        self.inflight = 0  # requests taken off the queue, not yet resolved
        # (gauge; queue_depth + inflight is the work ahead of a new
        # arrival — the replica pool's least-loaded dispatch signal)

    # -- mutators (called from batcher/registry/transport threads) --------

    def enqueued(self, n: int = 1) -> None:
        with self._lock:
            self.queue_depth += n

    def dropped(self, n: int) -> None:
        """Requests removed from the queue without being served."""
        with self._lock:
            self.queue_depth = max(0, self.queue_depth - n)

    def observe_batch(self, n_real: int, n_slots: int) -> None:
        with self._lock:
            self.n_batches += 1
            self.n_slots += n_slots
            self.n_padded += n_slots - n_real
            self.queue_depth = max(0, self.queue_depth - n_real)
            self.inflight += n_real

    def observe_request(
        self, latency_s: float, *, error: bool = False, exemplar: str | None = None
    ) -> None:
        with self._lock:
            now = time.perf_counter()
            if self._t_first is None:
                self._t_first = now
            self._t_last = now
            self.n_requests += 1
            self.inflight = max(0, self.inflight - 1)
            if error:
                self.n_errors += 1
        if not error:
            self.latency.observe(latency_s, exemplar=exemplar)

    def observe_stage(self, stage: str, seconds: float) -> None:
        """Record one request's time inside a single pipeline stage."""
        hist = self.stage.get(stage)
        if hist is None:  # unknown stages register lazily (forward compat)
            with self._lock:
                hist = self.stage.setdefault(stage, LatencyHistogram())
        hist.observe(seconds)

    def observe_reload(self) -> None:
        with self._lock:
            self.n_reloads += 1

    def shed(self, n: int = 1) -> None:
        """Requests turned away by admission control (never queued)."""
        with self._lock:
            self.n_shed += int(n)

    def rejected(self, n: int = 1) -> None:
        """Requests refused for non-load reasons (e.g. stopped batcher)."""
        with self._lock:
            self.n_rejected += int(n)

    # -- merge -------------------------------------------------------------

    def merge(self, other: "ServingMetrics") -> "ServingMetrics":
        """Combine two instances (e.g. per-model → fleet-wide) into a new
        one.  Counters add; histograms merge bucket-wise, so percentiles
        of the result equal percentiles of the union of observations."""
        out = ServingMetrics()
        with self._lock:
            a = self._counter_state()
        with other._lock:
            b = other._counter_state()
        for key in self.COUNTERS:
            setattr(out, key, a[key] + b[key])
        out._t0 = min(a["_t0"], b["_t0"])
        firsts = [t for t in (a["_t_first"], b["_t_first"]) if t is not None]
        lasts = [t for t in (a["_t_last"], b["_t_last"]) if t is not None]
        out._t_first = min(firsts) if firsts else None
        out._t_last = max(lasts) if lasts else None
        out.latency = self.latency.merge(other.latency)
        out.stage = {}
        for name in dict.fromkeys((*self.stage, *other.stage)):
            mine, theirs = self.stage.get(name), other.stage.get(name)
            if mine is not None and theirs is not None:
                out.stage[name] = mine.merge(theirs)
            else:
                solo = mine if mine is not None else theirs
                out.stage[name] = solo.merge(LatencyHistogram(solo.bucket_bounds()))
        return out

    def _counter_state(self) -> dict:
        return {
            "n_requests": self.n_requests, "n_batches": self.n_batches,
            "n_slots": self.n_slots, "n_padded": self.n_padded,
            "n_errors": self.n_errors, "n_reloads": self.n_reloads,
            "n_shed": self.n_shed, "n_rejected": self.n_rejected,
            "queue_depth": self.queue_depth, "inflight": self.inflight,
            "_t0": self._t0,
            "_t_first": self._t_first, "_t_last": self._t_last,
        }

    # -- wire state (fleet-aggregator scrape format) -----------------------

    #: counters carried by state()/from_state() and summed by merge()
    COUNTERS = (
        "n_requests", "n_batches", "n_slots", "n_padded", "n_errors",
        "n_reloads", "n_shed", "n_rejected", "queue_depth", "inflight",
    )

    def state(self) -> dict:
        """Full-fidelity plain-JSON state: every counter plus the
        latency/stage histograms in their exact bucket form.  This is
        what ``GET /metrics?detail=state`` serves and what the fleet
        aggregator merges — summed buckets, never averaged percentiles
        (`from_state(m.state()).merge(...)` is bit-identical to merging
        the live instances)."""
        with self._lock:
            counters = {k: int(getattr(self, k)) for k in self.COUNTERS}
        return {
            "counters": counters,
            "latency": self.latency.state(),
            "stages": {name: h.state() for name, h in self.stage.items()},
        }

    @classmethod
    def from_state(cls, state: dict) -> "ServingMetrics":
        """Exact inverse of :meth:`state`; loud on malformed input."""
        out = cls()
        try:
            counters = state["counters"]
            for key in cls.COUNTERS:
                setattr(out, key, int(counters.get(key, 0)))
            out.latency = LatencyHistogram.from_state(state["latency"])
            out.stage = {
                str(name): LatencyHistogram.from_state(h)
                for name, h in state.get("stages", {}).items()
            }
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed metrics state: {e}") from None
        return out

    # -- reads ------------------------------------------------------------

    def latency_percentiles_ms(
        self, ps: tuple[float, ...] = (50.0, 99.0)
    ) -> dict[str, float | None]:
        """Estimated end-to-end percentiles; None (not NaN) when empty."""
        return self.latency.percentiles_ms(ps)

    def snapshot(self) -> dict:
        """Point-in-time view: counts, occupancy, p50/p99, req/s, and a
        nested per-stage breakdown.

        `throughput_rps` spans first-to-last request completion (idle
        and setup time before/after traffic don't dilute it);
        `elapsed_s` is total time since construction.

        Strict JSON by construction: every value is a plain Python
        int/float/None (never a numpy scalar, never NaN/Inf), so
        ``json.dumps(snapshot(), allow_nan=False)`` always succeeds —
        the `/metrics` HTTP endpoint dumps it verbatim.
        """
        with self._lock:
            elapsed = time.perf_counter() - self._t0
            window = (
                self._t_last - self._t_first
                if self._t_first is not None
                else 0.0
            )
            out = {
                "n_requests": int(self.n_requests),
                "n_batches": int(self.n_batches),
                "n_errors": int(self.n_errors),
                "n_reloads": int(self.n_reloads),
                "n_shed": int(self.n_shed),
                "n_rejected": int(self.n_rejected),
                "queue_depth": int(self.queue_depth),
                "inflight": int(self.inflight),
                "batch_occupancy": (
                    (self.n_slots - self.n_padded) / self.n_slots
                    if self.n_slots
                    else None
                ),
                "elapsed_s": float(elapsed),
                "throughput_rps": (
                    self.n_requests / window if window > 0 else None
                ),
            }
        lat = self.latency.snapshot()
        for p in (50.0, 90.0, 99.0):
            out[f"p{p:g}_ms"] = lat[f"p{p:g}_ms"]
        out["mean_ms"] = lat["mean_ms"]
        out["stages"] = {name: h.snapshot() for name, h in self.stage.items()}
        return out
