"""`OnlineLearner`: the background trainer of the serving loop.

The torch counterpart of ``repro.online.learner``.  The actor/learner
split (DESIGN.md §10): serving threads *act* (answer predict traffic
and enqueue labeled feedback into a `FeedbackBuffer`); one daemon
thread per registered model *learns* — it drains the buffer in
batches, runs them through ``partial_fit(donate=True)`` (the fused
``fit_bundle`` kernels on a card: the (B, D) hypervector batch never
materializes, the (C, D) accumulator updates in place), and
periodically publishes checkpoints that the `ReloadWatcher` promotes
into the serving path mid-traffic.

Exactness contract — the whole point of doing this with HDC: class-sum
updates are integer additions, so the learner's published state is
**bit-identical** to offline ``partial_fit`` on the same base +
feedback stream, whatever chunking the HTTP clients or the drain loop
happened to impose, and to the JAX package's learner on the same
stream.  Tests pin the promoted engine's ``class_sums`` against an
offline replay.

Device work on a card.  The learner is one more thread beside the
drain threads (graph replays), the watcher (which captures a promoted
engine's graph) and the HTTP loop, and legacy-stream work or a
device-wide synchronise from any thread can break a capture running on
another.  So the learner owns a `torch.cuda.Stream` on its model's
device and does all of its device work inside it: the load of the base
model (in `start`), every ``partial_fit`` chunk, and the device-to-host
copies of each save.  It waits only on events of that stream.  The
model it trains is its own, loaded from the checkpoint onto the
engine's device, never the engine's model object (``partial_fit(donate=
True)`` updates the class sums in place).

Stage times: ``train`` ends on an event recorded on the learner's
stream after the chunk, so ``train_ms`` covers the chunk's device work,
not its enqueue; ``publish`` times the save (device-to-host copy and
the atomic checkpoint write); ``ingest`` is the oldest example's
put -> drain wait.

Lifecycle: ``start()`` attaches the learner to its `ModelRegistry`
entry (one learner per entry, like watchers), loads the base model
from the entry's checkpoint source at the engine's current step, and
spawns the drain thread.  ``ModelRegistry.shutdown()`` stops learners
**first** (no new checkpoint can appear), then watchers (no promotion
races the drain), then drains batchers and releases engines.  A
``stop(drain=True)`` trains whatever is still buffered and publishes a
final checkpoint, so no acknowledged feedback is ever lost.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.hdc_model import HDCModel
from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.online.buffer import FeedbackBuffer
from repro_torch.serving.metrics import ServingMetrics

#: online-path pipeline stages (mirrors serving's queue/assembly/device/
#: write): ingest = oldest example's put->drain wait, train = one
#: ``partial_fit`` chunk on the device (to an event of the learner's
#: stream), publish = checkpoint save
ONLINE_STAGES = ("ingest", "train", "publish")


class OnlineLearner:
    """Drain-train-publish daemon for one `ModelRegistry` entry."""

    def __init__(
        self,
        registry,
        name: str,
        *,
        source: str | Path | None = None,
        capacity: int = 1 << 16,
        train_batch: int = 512,
        publish_every_s: float = 2.0,
        publish_every_n: int | None = None,
        poll_interval_s: float = 0.02,
        keep_n: int = 4,
        on_publish=None,
    ):
        self._registry = registry
        self.name = name
        self.buffer = FeedbackBuffer(capacity)
        self.train_batch = int(train_batch)
        self.publish_every_s = float(publish_every_s)
        self.publish_every_n = publish_every_n
        self.poll_interval_s = float(poll_interval_s)
        self.keep_n = int(keep_n)
        self._on_publish = on_publish
        self._source = Path(source) if source is not None else None

        self._model: HDCModel | None = None  # live training state
        # the learner's own stream on its model's card (None on the CPU)
        self._stream: torch.cuda.Stream | None = None
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending_n = 0  # drained but not yet trained (sub-batch tail)

        self._lock = threading.Lock()  # counters + thread handle
        self._stop_event = threading.Event()
        self._drain_on_stop = True
        self._thread: threading.Thread | None = None
        # observability (ints/floats only; see snapshot())
        self.base_step: int | None = None
        self.step: int | None = None  # last published (or base) step
        self.n_trained = 0
        self.n_published = 0
        self._n_since_publish = 0
        self._last_publish_t = time.perf_counter()
        self.last_error: BaseException | None = None
        self.n_errors = 0
        self.publish_hist = LatencyHistogram()  # checkpoint save latency
        self.last_publish_ms: float | None = None
        # per-stage observability, same machinery as the serving path:
        # `metrics.stage` holds one histogram per ONLINE_STAGES entry and
        # `metrics.latency` records oldest-feedback-to-publish latency per
        # publish cycle.  Rendered as uhd_online_stage_latency_seconds /
        # uhd_online_feedback_to_publish_seconds in the Prometheus form
        # and merged exactly by the fleet aggregator.
        self.metrics = ServingMetrics()
        self.metrics.stage = {s: LatencyHistogram() for s in ONLINE_STAGES}
        self._oldest_unpublished_t: float | None = None
        self._stage_ms_since_publish = {s: 0.0 for s in ONLINE_STAGES}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "OnlineLearner":
        """Attach to the registry, load the base state, start draining.

        Idempotent; a stopped learner restarts and keeps its accumulated
        training state (its attachment survives ``stop()``, mirroring
        `ReloadWatcher`).
        """
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            if self._registry.learner(self.name) is not self:
                self._registry.attach_learner(self.name, self)
            if self._model is None:
                engine = self._registry.engine(self.name)
                source = self._source or engine.source
                if source is None:
                    raise ValueError(
                        f"model {self.name!r} was not loaded from a checkpoint "
                        "and no source= was given; the learner needs a "
                        "checkpoint directory to publish into"
                    )
                self._source = Path(source)
                step = engine.step
                # the learner's own copy of the state, on the engine's device
                device = engine.model.device
                if device.type == "cuda":
                    self._stream = torch.cuda.Stream(device=device)
                with self._on_stream():
                    self._model = HDCModel.load(self._source, step=step, device=device)
                self.base_step = self.step = (
                    step if step is not None else self._latest_step()
                )
            self.buffer.reopen()
            self._stop_event.clear()
            self._drain_on_stop = True
            self._thread = threading.Thread(
                target=self._run, name=f"hdc-online-learn-{self.name}", daemon=True
            )
            self._thread.start()
        return self

    def _on_stream(self):
        """This thread's current stream set to the learner's (a no-op on
        the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _wait(self) -> None:
        """Wait for the work queued so far on the learner's stream, by an
        event of that stream (never a device-wide synchronise)."""
        if self._stream is not None:
            done = torch.cuda.Event()
            done.record(self._stream)
            done.synchronize()

    def _latest_step(self) -> int:
        from repro_torch.checkpoint.manager import CheckpointManager

        return CheckpointManager(self._source).latest_step() or 0

    def stop(self, *, drain: bool = True, join: bool = True) -> None:
        """Idempotent; called first by `ModelRegistry.shutdown`.

        With ``drain`` (the default) the learner thread trains every
        example still buffered and publishes a final checkpoint before
        exiting — acknowledged feedback survives shutdown.
        """
        self._drain_on_stop = drain
        self._stop_event.set()
        self.buffer.close()  # wakes a parked drain; refuses new puts
        with self._lock:
            thread, self._thread = self._thread, None
        if join and thread is not None and thread is not threading.current_thread():
            thread.join()

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    # -- ingest (called by the transport on its event loop) ----------------

    def submit(self, images: np.ndarray, labels: np.ndarray) -> bool:
        """Enqueue validated feedback; False = shed (buffer full)."""
        return self.buffer.put(images, labels)

    # -- the learner thread ------------------------------------------------

    def _run(self) -> None:
        # a new thread starts on the legacy stream: every device op of the
        # learner runs on its own stream instead
        with self._on_stream():
            self._learn()

    def _learn(self) -> None:
        while not self._stop_event.is_set():
            got = self.buffer.drain(
                max_examples=8 * self.train_batch, timeout=self.poll_interval_s
            )
            try:
                if got is not None:
                    self._observe_ingest()
                    self._enqueue_pending(*got)
                    self._train_pending(flush=False)
                if self._dirty() and self._publish_due():
                    self._train_pending(flush=True)
                    self._publish()
            except Exception as e:  # keep learning; surface via snapshot()
                with self._lock:
                    self.n_errors += 1
                    self.last_error = e
        if self._drain_on_stop:
            try:
                while True:
                    got = self.buffer.drain(max_examples=None, timeout=0.0)
                    if got is None:
                        break
                    self._observe_ingest()
                    self._enqueue_pending(*got)
                self._train_pending(flush=True)
                if self._dirty():
                    self._publish()
            except Exception as e:
                with self._lock:
                    self.n_errors += 1
                    self.last_error = e

    def _observe_ingest(self) -> None:
        """Close the ingest span for the drain that just returned: the
        put->drain wait of its *oldest* example (the honest number — a
        mean over the block would hide head-of-line blocking)."""
        t_oldest = self.buffer.last_drained_oldest_t
        if t_oldest is None:
            return
        wait = max(0.0, time.perf_counter() - t_oldest)
        self.metrics.observe_stage("ingest", wait)
        self._stage_ms_since_publish["ingest"] += wait * 1e3
        if self._oldest_unpublished_t is None:
            # anchors this publish cycle's feedback-to-publish latency
            self._oldest_unpublished_t = t_oldest

    def _enqueue_pending(self, images: np.ndarray, labels: np.ndarray) -> None:
        self._pending.append((images, labels))
        self._pending_n += len(images)

    def _train_pending(self, *, flush: bool) -> None:
        """Run pending examples through donated-state ``partial_fit`` in
        fixed ``train_batch`` chunks (one compiled shape in steady
        state).  The sub-batch tail stays pending until ``flush`` — a
        publish always folds everything drained so far."""
        if self._pending_n < self.train_batch and not (flush and self._pending_n):
            return
        x = np.concatenate([b for b, _ in self._pending])
        y = np.concatenate([l for _, l in self._pending])
        self._pending, self._pending_n = [], 0
        i = 0
        while len(x) - i >= self.train_batch:
            self._fit(x[i : i + self.train_batch], y[i : i + self.train_batch])
            i += self.train_batch
        if i < len(x):
            if flush:
                self._fit(x[i:], y[i:])
            else:
                self._enqueue_pending(x[i:], y[i:])

    def _fit(self, x: np.ndarray, y: np.ndarray) -> None:
        # donated-state hot loop: the (C, D) accumulator updates in place;
        # the labels are checked on the host before they are copied over
        t0 = time.perf_counter()
        self._model = self._model.partial_fit(x, y, donate=True)
        self._wait()  # the stage covers the chunk's device work
        dt = time.perf_counter() - t0
        self.metrics.observe_stage("train", dt)
        self._stage_ms_since_publish["train"] += dt * 1e3
        with self._lock:
            self.n_trained += len(x)
            self._n_since_publish += len(x)

    def _dirty(self) -> bool:
        with self._lock:
            return self._n_since_publish + self._pending_n > 0

    def _publish_due(self) -> bool:
        with self._lock:
            if time.perf_counter() - self._last_publish_t >= self.publish_every_s:
                return True
            return (
                self.publish_every_n is not None
                and self._n_since_publish + self._pending_n >= self.publish_every_n
            )

    def _publish(self) -> None:
        step = (self.step or 0) + 1
        t0 = time.perf_counter()
        self._model.save(self._source, step=step, keep_n=self.keep_n)
        elapsed = time.perf_counter() - t0
        self.publish_hist.observe(elapsed)
        self.metrics.observe_stage("publish", elapsed)
        self._stage_ms_since_publish["publish"] += elapsed * 1e3
        self.last_publish_ms = elapsed * 1e3
        # close the cycle-level span: oldest acknowledged feedback ->
        # checkpoint on disk (the user-visible freshness number)
        t_oldest, self._oldest_unpublished_t = self._oldest_unpublished_t, None
        if t_oldest is not None:
            self.metrics.latency.observe(
                max(0.0, time.perf_counter() - t_oldest)
            )
        spans = {f"{s}_ms": float(v)
                 for s, v in self._stage_ms_since_publish.items()}
        self._stage_ms_since_publish = {s: 0.0 for s in ONLINE_STAGES}
        with self._lock:
            self.step = step
            self.n_published += 1
            self._n_since_publish = 0
            self._last_publish_t = time.perf_counter()
        traces = getattr(self._registry, "traces", None)
        if traces is not None:
            # t_mono = save *start*: the checkpoint cannot be promoted —
            # and therefore no request span can carry the new step —
            # before the save began, so this event provably precedes the
            # first span served by the promoted engine.  `spans` breaks
            # the cycle down (ingest wait / device train / save) like a
            # request trace's queue/device/write.
            traces.record_event(
                "publish",
                model=self.name,
                step=int(step),
                duration_ms=elapsed * 1e3,
                t_mono=t0,
                spans=spans,
            )
        if self._on_publish is not None:
            try:
                self._on_publish(self.name, step)
            except Exception:  # observer hooks must not stop the learner
                pass

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        """Plain ints/floats (json.dumps-able verbatim): merged into the
        `/metrics` response under the model's ``"online"`` key."""
        buf = self.buffer.snapshot()
        with self._lock:
            staleness = (
                time.perf_counter() - self._last_publish_t
                if self._n_since_publish + self._pending_n + buf["depth"] > 0
                else 0.0
            )
            return {
                "n_ingested": buf["n_ingested"],
                "n_shed": buf["n_shed"],
                "n_trained": int(self.n_trained),
                "n_published": int(self.n_published),
                "n_errors": int(self.n_errors),
                "buffered": buf["depth"],
                "lag_examples": buf["n_ingested"] - int(self.n_trained),
                "staleness_s": float(staleness),
                "base_step": self.base_step,
                "step": self.step,
                "last_publish_ms": self.last_publish_ms,
                # per-stage percentiles (ingest wait / train / publish)
                # plus the cycle-level feedback-to-publish latency
                "stages": {
                    s: h.snapshot() for s, h in self.metrics.stage.items()
                },
                "feedback_to_publish": self.metrics.latency.snapshot(),
            }

    def describe(self) -> dict:
        out = self.snapshot()
        out.update(
            name=self.name,
            running=self.running(),
            train_batch=int(self.train_batch),
            publish_every_s=float(self.publish_every_s),
            capacity=int(self.buffer.capacity),
        )
        return out
