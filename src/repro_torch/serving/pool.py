"""`ReplicaPool`: N serving engines behind one batcher-shaped facade.

The torch counterpart of ``repro.serving.pool``: one registry entry fans
out over N engine replicas, each a :class:`MicroBatcher` around its own
:class:`ServingEngine` (whose execution backend pins one device or
shards a device group; see
`repro_torch.serving.execution.plan_executions`).
The pool quacks like a `MicroBatcher` (`submit`, `submit_block`,
`queue_depth`, `metrics`, `engine`, `start`, `stop`, `swap_engine`), so
the registry, transport, and watcher need no special cases beyond
duck-typed probes.

Dispatch is **least-loaded, span-informed**: each replica's pending work
(queued + in-flight requests) is weighted by its observed device-stage
mean from `repro_torch.obs` — a replica whose device steps run 3x slower
(e.g. sharded over a busier group) gets proportionally fewer requests —
with round-robin rotation breaking ties so an idle fleet interleaves.
A whole `submit_block` lands on ONE replica: together with the
batcher's block-granular FIFO this keeps every response batch on one
device step of one engine generation.

Promotion is **atomic per entry**: `swap_engines` replaces every
replica's engine inside one pool-lock hold, and dispatch takes the same
lock — no new request can be routed while the fleet is half-swapped, so
after any single dispatch observes the new step, every replica has it.
`reload_to` (called by `ModelRegistry.hot_reload`, hence by the
`ReloadWatcher`) loads the checkpoint once, builds one engine per
replica *reusing each replica's execution backend* (placement survives
promotion), warms them all (each captures its CUDA graph), then swaps — the watcher records its
promotion event with the poll-start timestamp, which precedes every
span any new-step replica serves.

Admission control lives at the pool: `max_depth` bounds the *fleet*
backlog and sheds on the pool's own `ServingMetrics` (a durable
instance — HTTP 429 accounting survives engine swaps).  Fleet-merged
observability comes from `merged_metrics()`, which folds every
replica's counters and histograms into one view via
`ServingMetrics.merge` — exact by construction (bucket-wise integer
addition).
"""

from __future__ import annotations

import threading

from repro_torch.obs.trace import OWNER_BATCHER, TraceBuffer
from repro_torch.serving.batcher import MicroBatcher, QueueFull
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.metrics import ServingMetrics


class ReplicaPool:
    """Least-loaded dispatch over N micro-batched engine replicas."""

    placement = "pool"

    def __init__(
        self,
        engines: list[ServingEngine],
        *,
        max_delay_ms: float = 2.0,
        max_depth: int | None = None,
        name: str | None = None,
        traces: TraceBuffer | None = None,
    ):
        if not engines:
            raise ValueError("ReplicaPool needs at least one engine")
        self.name = name
        self.max_depth = max_depth  # fleet-wide bound; replicas are unbounded
        self.metrics = ServingMetrics()  # pool-level admission accounting
        self._lock = threading.Lock()
        self._rr = 0  # rotation origin: round-robins ties
        self._closed = False
        self._draining: set[int] = set()  # replica indices out of rotation
        # dispatch distribution (submit_block calls routed per replica);
        # the chosen replica is also stamped on every request's trace
        # (`RequestTrace.replica` via the replica's MicroBatcher), so a
        # span resolved at `/v1/traces?id=` — locally or at the fleet
        # aggregator — names the exact replica that served it
        self.n_dispatched = [0] * len(engines)
        self.replicas = [
            MicroBatcher(
                engine, max_delay_ms=max_delay_ms, max_depth=None,
                name=name, traces=traces, replica=i,
            )
            for i, engine in enumerate(engines)
        ]

    # -- batcher facade ----------------------------------------------------

    @property
    def engine(self) -> ServingEngine:
        """Representative engine (replica 0) — config/step introspection;
        every replica serves the same model at the same step."""
        return self.replicas[0].engine

    def queue_depth(self) -> int:
        return sum(r.queue_depth() for r in self.replicas)

    def submit(self, image, *, request_id=None, trace_owner=OWNER_BATCHER):
        with self._lock:
            self._admit(1)
            return self._pick().submit(
                image, request_id=request_id, trace_owner=trace_owner
            )

    def submit_block(self, images, *, request_ids=None, trace_owner=OWNER_BATCHER):
        with self._lock:
            self._admit(len(images))
            return self._pick().submit_block(
                images, request_ids=request_ids, trace_owner=trace_owner
            )

    def submit_search_block(
        self, queries, k, *, request_ids=None, trace_owner=OWNER_BATCHER
    ):
        """Route one search batch to one replica (same one-step guarantee
        as `submit_block`; see `MicroBatcher.submit_search_block`)."""
        with self._lock:
            self._admit(len(queries))
            return self._pick().submit_search_block(
                queries, k, request_ids=request_ids, trace_owner=trace_owner
            )

    def submit_many(self, images):
        return [self.submit(img) for img in images]

    def _admit(self, n: int) -> None:
        """Fleet-wide admission under the pool lock; sheds/rejects on the
        pool's own durable metrics (never a replica's)."""
        if self._closed:
            self.metrics.rejected(n)
            raise RuntimeError("pool is stopped; request rejected")
        if self.max_depth is not None:
            depth = self.queue_depth()
            if depth + n > self.max_depth:
                self.metrics.shed(n)
                raise QueueFull(
                    f"fleet queue depth {depth} + {n} exceeds max_depth "
                    f"{self.max_depth}; shed"
                )

    def _pick(self) -> MicroBatcher:
        """Least-loaded replica: (queued + in-flight) requests weighted by
        the replica's observed device-stage mean seconds (the span data
        `repro_torch.obs` collects).  Replicas with no observations yet borrow
        the fleet mean (or 1.0), keeping scores comparable; the rotation
        origin round-robins exact ties.  Draining replicas (see
        :meth:`drain`) are out of rotation entirely."""
        means: list[float | None] = []
        for r in self.replicas:
            dev = r.metrics.stage.get("device")
            n = dev.count if dev is not None else 0
            means.append(dev.sum_s / n if n else None)
        known = [m for m in means if m is not None]
        default = sum(known) / len(known) if known else 1.0
        n = len(self.replicas)
        best, best_score = None, None
        for k in range(n):
            i = (self._rr + k) % n
            if i in self._draining:
                continue
            r = self.replicas[i]
            pending = r.queue_depth() + r.metrics.inflight
            weight = means[i] if means[i] is not None else default
            score = pending * weight
            if best_score is None or score < best_score:
                best, best_score = i, score
        if best is None:
            raise RuntimeError(
                f"every replica of the {n}-replica pool is draining; "
                "undrain one before dispatching"
            )
        self._rr = (best + 1) % n
        self.n_dispatched[best] += 1
        return self.replicas[best]

    # -- rolling restarts --------------------------------------------------

    def drain(self, i: int) -> None:
        """Take replica ``i`` out of dispatch rotation and synchronously
        serve whatever its batcher still queues — the rolling-restart
        building block (DESIGN.md §12 follow-ups).  The replica's drain
        thread keeps running (already-dispatched work completes and a
        later :meth:`undrain` needs no restart); it simply receives no
        new requests, and `/healthz` reports it ``draining``."""
        i = int(i)
        if not 0 <= i < len(self.replicas):
            raise IndexError(
                f"replica {i} out of range for a {len(self.replicas)}-replica pool"
            )
        with self._lock:
            self._draining.add(i)
        self.replicas[i].flush()

    def undrain(self, i: int) -> None:
        """Return replica ``i`` to dispatch rotation (idempotent)."""
        i = int(i)
        if not 0 <= i < len(self.replicas):
            raise IndexError(
                f"replica {i} out of range for a {len(self.replicas)}-replica pool"
            )
        with self._lock:
            self._draining.discard(i)

    @property
    def draining(self) -> tuple[int, ...]:
        """Sorted indices of replicas currently out of rotation."""
        with self._lock:
            return tuple(sorted(self._draining))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaPool":
        with self._lock:
            self._closed = False
        for r in self.replicas:
            r.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        with self._lock:
            self._closed = True
        for r in self.replicas:
            r.stop(drain=drain)

    # -- hot reload --------------------------------------------------------

    def swap_engine(self, engine: ServingEngine) -> None:
        """Single-engine swap is ill-defined for a fleet — refuse loudly
        so a caller can never half-promote a pool."""
        raise TypeError(
            "ReplicaPool has no single engine to swap; use swap_engines "
            "(one per replica) or reload_to(step)"
        )

    def swap_engines(self, engines: list[ServingEngine]) -> None:
        """Swap every replica's engine inside ONE pool-lock hold.

        Dispatch also takes the pool lock, so no request can be routed
        between the first and last per-replica swap: promotion is atomic
        with respect to admission.  Queued work is preserved per replica
        (MicroBatcher.swap_engine keeps its FIFO)."""
        if len(engines) != len(self.replicas):
            raise ValueError(
                f"{len(engines)} engines for {len(self.replicas)} replicas"
            )
        with self._lock:
            for r, engine in zip(self.replicas, engines):
                r.swap_engine(engine)
        self.metrics.observe_reload()

    def reload_to(self, step: int | None = None) -> int:
        """Load a newer checkpoint step and promote it to every replica.

        The model loads from disk ONCE; each replica gets its own engine
        built on its existing execution backend (a sharded replica stays
        sharded on its same device group), warmed before the swap so no
        replica ever serves an uncaptured step."""
        old = self.engine
        if old.source is None:
            raise ValueError("pool engines have no checkpoint source")
        if step is None:
            from repro_torch.checkpoint.manager import CheckpointManager

            step = CheckpointManager(old.source).latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {old.source}")
        from repro_torch.core.hdc_model import HDCModel

        model = HDCModel.load(old.source, step=step, device="cpu")  # placed per engine
        engines = [
            ServingEngine(
                model,
                batch_size=r.engine.batch_size,
                step=step,
                source=old.source,
                execution=r.engine.execution,
            ).warmup()
            for r in self.replicas
        ]
        self.swap_engines(engines)
        return int(step)

    # -- observability -----------------------------------------------------

    def merged_metrics(self) -> ServingMetrics:
        """Fleet view: pool admission counters + every replica's request
        counters and latency/stage histograms, merged exactly."""
        out = self.metrics
        for r in self.replicas:
            out = out.merge(r.metrics)
        return out

    def describe(self) -> dict:
        reps = [r.engine.describe() for r in self.replicas]
        out = dict(reps[0])
        out["placement"] = self.placement
        out["n_replicas"] = len(reps)
        out["replicas"] = reps
        out["n_dispatched"] = [int(c) for c in self.n_dispatched]
        out["draining"] = list(self.draining)
        return out
