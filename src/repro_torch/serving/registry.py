"""Multi-model serving registry with hot checkpoint reload.

The torch counterpart of ``repro.serving.registry``.  One process serves
many named models (several D/encoder variants of the paper's classifier,
A/B steps of the same model, ...).  Each entry is a micro-batcher
wrapping its live engine; `hot_reload` watches the checkpoint directory
and, when the trainer has published a newer step, builds a fresh packed
engine, warms it (capturing its CUDA graph where it has one), and swaps
it into the batcher atomically.

Hot-reload contract (pinned by tests/test_torch_serving.py):

  * queued requests are never dropped — the batcher keeps its FIFO and
    serves the remainder with the new engine;
  * an in-flight batch finishes on the old engine (engines are
    immutable; the swap only changes which engine the *next* drain step
    picks up);
  * the new engine is warmed on the caller's thread while the drain
    thread keeps serving the old one: its graph is captured on its own
    stream, which nothing the old engine does can disturb.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

from repro_torch.obs.trace import TraceBuffer
from repro_torch.serving.batcher import MicroBatcher, ServingFuture
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.pool import ReplicaPool


class ModelRegistry:
    """name -> live micro-batcher; the process-level serving map.

    The batcher is the single source of truth for which engine is live
    (`batcher.engine`, swapped atomically under its condition lock) —
    the registry never holds a second engine reference that could skew
    from what the drain loop actually serves.

    The registry also owns the process-wide :class:`TraceBuffer`: every
    batcher it creates appends finished request traces there, and the
    watcher/learner lifecycle events land in the same ring, so
    ``GET /v1/traces`` shows the promotion timeline interleaved with the
    requests it affected.
    """

    def __init__(
        self,
        *,
        trace_capacity: int = 2048,
        trace_jsonl: str | os.PathLike | None = None,
        trace_jsonl_sample: int = 1,
    ):
        self._lock = threading.RLock()
        # a "batcher" entry is a MicroBatcher or a ReplicaPool — the
        # registry/transport/watcher code paths are duck-typed over the
        # shared facade (submit/submit_block/queue_depth/metrics/engine)
        self._entries: dict[str, MicroBatcher | ReplicaPool] = {}
        self._watchers: dict[str, object] = {}  # name -> ReloadWatcher-like
        self._learners: dict[str, object] = {}  # name -> OnlineLearner-like
        self.traces = TraceBuffer(
            trace_capacity,
            jsonl_path=trace_jsonl,
            jsonl_sample=trace_jsonl_sample,
        )

    # -- lifecycle ---------------------------------------------------------

    def register(
        self,
        name: str,
        engine: ServingEngine,
        *,
        max_delay_ms: float = 2.0,
        max_depth: int | None = None,
        start: bool = False,
    ) -> MicroBatcher:
        """Put a model behind a name; returns its micro-batcher."""
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            batcher = MicroBatcher(
                engine, max_delay_ms=max_delay_ms, max_depth=max_depth,
                name=name, traces=self.traces,
            )
            self._entries[name] = batcher
        if start:
            batcher.start()
        return batcher

    def register_pool(
        self,
        name: str,
        engines: list[ServingEngine],
        *,
        max_delay_ms: float = 2.0,
        max_depth: int | None = None,
        start: bool = False,
    ) -> ReplicaPool:
        """Put a replica fleet behind one name; returns its pool."""
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            pool = ReplicaPool(
                engines, max_delay_ms=max_delay_ms, max_depth=max_depth,
                name=name, traces=self.traces,
            )
            self._entries[name] = pool
        if start:
            pool.start()
        return pool

    def register_checkpoint(
        self,
        name: str,
        path: str | Path,
        *,
        step: int | None = None,
        batch_size: int = 64,
        placement: str = "auto",
        replicas: int = 1,
        devices=None,
        max_delay_ms: float = 2.0,
        max_depth: int | None = None,
        start: bool = False,
    ) -> MicroBatcher | ReplicaPool:
        """Load-and-register in one call (the common server boot path).

        ``replicas``/``placement``/``devices`` plan the fleet via
        `repro_torch.serving.execution.plan_executions` (``devices``
        defaults to every visible card; ``devices=["cpu"]`` serves on the
        CPU): the default (one replica, auto placement) is the classic
        single-engine entry;
        anything bigger loads the checkpoint once, builds one warmed
        engine per planned execution backend, and registers a
        :class:`ReplicaPool`.  A single replica with explicit placement
        (e.g. ``"sharded"`` over the whole mesh) stays a plain
        MicroBatcher around one engine."""
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.core.hdc_model import HDCModel
        from repro_torch.serving.execution import plan_executions

        if step is None:
            step = CheckpointManager(path).latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
        model = HDCModel.load(path, step=step, device="cpu")  # placed per engine
        executions = plan_executions(
            model.cfg.d, replicas=replicas, placement=placement, devices=devices,
        )
        engines = [
            ServingEngine(
                model, batch_size=batch_size, step=step, source=path,
                execution=execution,
            ).warmup()
            for execution in executions
        ]
        if len(engines) == 1:
            return self.register(
                name, engines[0], max_delay_ms=max_delay_ms,
                max_depth=max_depth, start=start,
            )
        return self.register_pool(
            name, engines, max_delay_ms=max_delay_ms, max_depth=max_depth,
            start=start,
        )

    def attach_watcher(self, name: str, watcher) -> None:
        """Tie a lifecycle watcher (anything with ``stop()``) to an entry
        so `shutdown`/`unregister` stop it before draining the batcher.
        One watcher per entry; `ReloadWatcher.start` calls this."""
        with self._lock:
            if name not in self._entries:
                raise KeyError(
                    f"unknown model {name!r}; registered: {sorted(self._entries)}"
                )
            if name in self._watchers:
                raise ValueError(f"model {name!r} already has a watcher")
            self._watchers[name] = watcher

    def watcher(self, name: str):
        with self._lock:
            return self._watchers.get(name)

    def attach_learner(self, name: str, learner) -> None:
        """Tie an online learner (anything with ``stop()``) to an entry.
        Learners stop *before* watchers on teardown: no new checkpoint
        can be published once shutdown begins, so no promotion of a
        mid-shutdown artifact can race the batcher drain.  One learner
        per entry; `OnlineLearner.start` calls this."""
        with self._lock:
            if name not in self._entries:
                raise KeyError(
                    f"unknown model {name!r}; registered: {sorted(self._entries)}"
                )
            if name in self._learners:
                raise ValueError(f"model {name!r} already has a learner")
            self._learners[name] = learner

    def learner(self, name: str):
        with self._lock:
            return self._learners.get(name)

    def unregister(self, name: str, *, drain: bool = True) -> None:
        """Tear one entry down in deterministic order: its learner first
        (no new checkpoint appears), then its watcher (no promotion can
        race the drain), then the batcher (serving the queued remainder
        when `drain`), then the engine reference is dropped with the
        entry."""
        with self._lock:
            batcher = self._entries.pop(name)
            watcher = self._watchers.pop(name, None)
            learner = self._learners.pop(name, None)
        if learner is not None:
            learner.stop(drain=drain)
        if watcher is not None:
            watcher.stop()
        batcher.stop(drain=drain)

    def shutdown(self, *, drain: bool = True) -> None:
        """Stop everything, idempotently, in name order: all learners,
        then all watchers, then each batcher (drained), engines released
        with the entries.  Safe to call twice or concurrently with
        `unregister`."""
        with self._lock:
            learners = sorted(self._learners.items())
            self._learners = {}
        for _, learner in learners:
            learner.stop(drain=drain)
        with self._lock:
            watchers = sorted(self._watchers.items())
            self._watchers = {}
        for _, watcher in watchers:
            watcher.stop()
        while True:
            names = self.names()
            if not names:
                self.traces.close()  # flush + release the JSONL handle
                return
            for name in names:
                try:
                    self.unregister(name, drain=drain)
                except KeyError:  # lost a race with a concurrent teardown
                    pass

    def stop_all(self, *, drain: bool = True) -> None:
        """Back-compat alias for :meth:`shutdown`."""
        self.shutdown(drain=drain)

    # -- lookup ------------------------------------------------------------

    def names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._entries))

    def engine(self, name: str) -> ServingEngine:
        return self.batcher(name).engine

    def batcher(self, name: str) -> MicroBatcher | ReplicaPool:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise KeyError(
                    f"unknown model {name!r}; registered: {sorted(self._entries)}"
                ) from None

    def submit(self, name: str, image) -> ServingFuture:
        """Queue one request against a named model."""
        return self.batcher(name).submit(image)

    def describe_entry(self, name: str) -> dict:
        """Entry description: a pool describes the fleet (placement
        "pool", per-replica engine details); a single engine describes
        itself (placement "device"/"sharded")."""
        batcher = self.batcher(name)
        describe = getattr(batcher, "describe", None)
        if describe is not None:
            return describe()
        return batcher.engine.describe()

    def describe(self) -> dict[str, dict]:
        return {name: self.describe_entry(name) for name in self.names()}

    def metrics_state(self) -> dict[str, dict]:
        """Full-fidelity per-model metrics for fleet aggregation: the
        exact bucket-level `ServingMetrics.state()` (fleet-merged for
        pool entries) plus the learner snapshot.  Served by
        ``GET /metrics?detail=state`` and read directly by in-process
        scrape targets — one code path, so HTTP and local aggregation
        can never skew."""
        out = {}
        for name in self.names():
            try:
                batcher = self.batcher(name)
            except KeyError:  # racing an unregister
                continue
            merged = getattr(batcher, "merged_metrics", None)
            metrics = merged() if merged is not None else batcher.metrics
            entry = {"serving": metrics.state()}
            learner = self.learner(name)
            if learner is not None:
                entry["online"] = learner.snapshot()
                # exact-merge form of the online-path histograms, for the
                # same bit-identical fleet aggregation as "serving"
                metrics_state = getattr(learner, "metrics", None)
                if metrics_state is not None:
                    entry["online_metrics"] = metrics_state.state()
            out[name] = entry
        return out

    # -- hot reload --------------------------------------------------------

    def hot_reload(self, name: str, *, step: int | None = None) -> int | None:
        """Swap `name` to a newer checkpoint step without dropping queued
        requests.  Returns the step swapped to, or None if the entry is
        already at the newest published step.  `step` forces an exact
        step (including rollback to an older one).

        A pool entry promotes through `ReplicaPool.reload_to`: the
        checkpoint loads once, every replica gets a warmed engine on its
        existing execution backend, and all replicas swap inside one
        pool-lock hold — promotion is atomic per entry."""
        batcher = self.batcher(name)
        old = batcher.engine
        if old.source is None:
            raise ValueError(
                f"model {name!r} was not loaded from a checkpoint; "
                "hot reload needs a source directory"
            )
        if step is None:
            from repro_torch.checkpoint.manager import CheckpointManager

            step = CheckpointManager(old.source).poll_latest(after=old.step)
            if step is None:
                return None
        reload_to = getattr(batcher, "reload_to", None)
        if reload_to is not None:
            return reload_to(step)
        engine = ServingEngine.from_checkpoint(
            old.source, step=step, batch_size=old.batch_size,
            execution=old.execution,  # placement survives promotion
        ).warmup()  # captures the new engine's graph before the swap
        batcher.swap_engine(engine)
        return step
