"""Slot-based continuous micro-batching for HDC inference.

The torch counterpart of ``repro.serving.batcher``: requests arrive one
image at a time, the device wants one static batch shape.  The batcher
keeps a FIFO of pending requests and a drain loop that

  * takes up to ``engine.batch_size`` requests per step (after a short
    coalescing window so sparse traffic still forms fuller batches),
  * writes them into the engine's staging rows (pinned on a card) and
    zeroes the rest — padded rows are masked out on delivery, never
    returned — so every step has the static shape the engine captured
    its CUDA graph at (:mod:`repro_torch.serving.engine`) and replays,
  * delivers each request's label through its :class:`ServingFuture`.

The FIFO is **block-granular**: `submit_block` enqueues its requests as
one unit and `_take_batch` only takes whole blocks (it splits a block
solely when the block alone exceeds the batch size).  A response batch
admitted together is therefore served by ONE device step — and, since
the engine reference is read once per step, by one engine generation: a
hot reload landing mid-stream can never mix model steps within one
response block.

Blocks carry an **operation tag**: classify blocks resolve each future
to an int label through ``engine.predict``; search blocks
(``submit_search_block``) resolve to an ``((k,) indices, (k,)
distances)`` row pair through ``engine.search``.  A drain step only
coalesces consecutive blocks of the same (op, k), so one device step
never mixes operations, and each distinct k captures its search graph
once, just like the static batch shape.

The engine reference is read once per drain step under the lock —
:meth:`swap_engine` (the hot-reload path) therefore never drops queued
requests: whatever is still in the FIFO is simply served by the new
engine on the next step, while an in-flight batch finishes on the old
one.  The device step runs on the engine's own stream (the engine's
business); the batcher waits on nothing device-wide.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np

from repro_torch.obs.profiler import timed_block
from repro_torch.obs.trace import OWNER_BATCHER, OWNER_TRANSPORT, RequestTrace, TraceBuffer
from repro_torch.serving.engine import OP_PREDICT, ServingEngine
from repro_torch.serving.metrics import ServingMetrics


class QueueFull(RuntimeError):
    """Admission control: the batcher's bounded queue is at `max_depth`.

    Raised by :meth:`MicroBatcher.submit` instead of queueing — overload
    degrades loudly (the HTTP transport maps this to 429) rather than
    growing an unbounded backlog until the process OOMs.
    """


# every queued block is (op, pairs): OP_PREDICT (the engine's) resolves its
# futures to int labels, ("search", k) to ((k,) int32 indices, (k,) int32
# distances) row pairs
__all__ = ["MicroBatcher", "OP_PREDICT", "QueueFull", "ServingFuture"]


class ServingFuture:
    """Handle for one queued request; resolves to an int label
    (classify) or an (indices, distances) row pair (search)."""

    __slots__ = ("_event", "_label", "_error", "_callbacks", "_cb_lock",
                 "t_submit", "t_done", "trace")

    def __init__(self):
        self._event = threading.Event()
        self._label = None  # int label or (indices, distances) row pair
        self._error: BaseException | None = None
        self._callbacks: list = []
        self._cb_lock = threading.Lock()
        self.t_submit = time.perf_counter()
        self.t_done: float | None = None
        self.trace: RequestTrace | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._label  # label or (indices, distances) per the op

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` when the future resolves (immediately if it
        already has).  The asyncio transport uses this to bridge drain
        threads to event-loop futures without burning an executor thread
        per in-flight request."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def latency_s(self) -> float:
        assert self.t_done is not None, "request not finished"
        return self.t_done - self.t_submit

    def _resolve(self, label, error: BaseException | None = None):
        if self.t_done is None:  # drain loop may stamp it early so that
            self.t_done = time.perf_counter()  # metrics precede the wakeup
        self._label, self._error = label, error
        with self._cb_lock:
            # set under the lock so add_done_callback never misses: it is
            # either appended before this (and invoked below) or sees the
            # event set and runs inline
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # a callback must never kill the drain loop
                pass


class MicroBatcher:
    """Pad-and-mask micro-batcher over one :class:`ServingEngine`."""

    def __init__(
        self,
        engine: ServingEngine,
        *,
        max_delay_ms: float = 2.0,
        max_depth: int | None = None,
        metrics: ServingMetrics | None = None,
        name: str | None = None,
        traces: TraceBuffer | None = None,
        replica: int | None = None,
    ):
        self.engine = engine
        self.max_delay_s = max_delay_ms / 1e3
        self.max_depth = max_depth  # None = unbounded (library use)
        self.metrics = metrics or ServingMetrics()
        self.name = name  # model label stamped onto traces
        self.traces = traces  # shared ring; None disables tracing
        self.replica = replica  # pool slot index stamped onto traces
        # block-granular FIFO: each entry is (op, [(img, fut), ...]) of
        # one admission (see module docstring); _n_queued tracks requests
        self._queue: collections.deque[
            tuple[tuple[str, int], list[tuple[np.ndarray, ServingFuture]]]
        ] = collections.deque()
        self._n_queued = 0
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._running = False
        self._closed = False  # set by stop(); submits are rejected after

    # -- submission --------------------------------------------------------

    def _new_future(
        self, request_id: str | None, trace_owner: str
    ) -> ServingFuture:
        """Future plus (when a trace ring is attached) its trace, whose
        owner is fixed at creation — under the submit lock — so the drain
        thread and the transport can never race to claim it."""
        fut = ServingFuture()
        if self.traces is not None:
            fut.trace = RequestTrace(
                request_id,
                model=self.name,
                owner=trace_owner,
                t_submit=fut.t_submit,
                replica=self.replica,
            )
        return fut

    def submit(
        self,
        image,
        *,
        request_id: str | None = None,
        trace_owner: str = OWNER_BATCHER,
    ) -> ServingFuture:
        """Queue one (H,) image; returns a future resolving to its label.

        ``request_id`` carries a caller-minted id (the HTTP boundary)
        into the trace; direct callers get one minted here.  With
        ``trace_owner=OWNER_TRANSPORT`` the caller takes responsibility
        for finalizing the trace (it owns the response-write span);
        otherwise the drain loop finalizes at resolve time.
        """
        image = np.asarray(image, np.float32)
        if image.ndim != 1:
            raise ValueError(f"submit takes one (H,) image, got {image.shape}")
        fut = self._new_future(request_id, trace_owner)
        with self._cv:
            if self._closed:
                self.metrics.rejected()
                raise RuntimeError("batcher is stopped; request rejected")
            if self.max_depth is not None and self._n_queued >= self.max_depth:
                self.metrics.shed()
                raise QueueFull(
                    f"queue depth {self._n_queued} at max_depth "
                    f"{self.max_depth}; request shed"
                )
            self._queue.append((OP_PREDICT, [(image, fut)]))
            self._n_queued += 1
            self.metrics.enqueued()
            self._cv.notify_all()
        return fut

    def submit_many(self, images) -> list[ServingFuture]:
        return [self.submit(img) for img in np.asarray(images, np.float32)]

    def submit_block(
        self,
        images,
        *,
        request_ids: list[str] | None = None,
        trace_owner: str = OWNER_BATCHER,
    ) -> list[ServingFuture]:
        """All-or-nothing batch admission under one lock: either every
        image is queued or none is (`QueueFull`/`RuntimeError`).  The
        HTTP transport uses this so a mid-batch race with the depth
        bound or a concurrent `stop()` can't strand an already-submitted
        prefix whose results nobody will read."""
        return self._submit_block(OP_PREDICT, images, request_ids, trace_owner)

    def submit_search_block(
        self,
        queries,
        k: int,
        *,
        request_ids: list[str] | None = None,
        trace_owner: str = OWNER_BATCHER,
    ) -> list[ServingFuture]:
        """All-or-nothing admission of a search batch: each future
        resolves to the query's ((k,) int32 indices, (k,) int32
        distances) row pair, nearest first, lowest index winning ties
        (DESIGN.md §14).  Same admission/trace semantics as
        :meth:`submit_block`; blocks with different k never share a
        device step."""
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return self._submit_block(("search", k), queries, request_ids, trace_owner)

    def _submit_block(
        self,
        op: tuple[str, int],
        images,
        request_ids: list[str] | None,
        trace_owner: str,
    ) -> list[ServingFuture]:
        images = np.asarray(images, np.float32)
        if images.ndim != 2:
            raise ValueError(f"submit_block takes (n, H) images, got {images.shape}")
        if request_ids is not None and len(request_ids) != len(images):
            raise ValueError(
                f"{len(request_ids)} request_ids for {len(images)} images"
            )
        with self._cv:
            if self._closed:
                self.metrics.rejected(len(images))
                raise RuntimeError("batcher is stopped; request rejected")
            if (
                self.max_depth is not None
                and self._n_queued + len(images) > self.max_depth
            ):
                self.metrics.shed(len(images))
                raise QueueFull(
                    f"queue depth {self._n_queued} + {len(images)} exceeds "
                    f"max_depth {self.max_depth}; batch shed"
                )
            futures = [
                self._new_future(
                    request_ids[i] if request_ids is not None else None,
                    trace_owner,
                )
                for i in range(len(images))
            ]
            # one block: the whole response batch is served by one device
            # step on one engine generation (see module docstring)
            self._queue.append((op, list(zip(images, futures))))
            self._n_queued += len(images)
            self.metrics.enqueued(len(images))
            self._cv.notify_all()
        return futures

    def swap_engine(self, engine: ServingEngine) -> None:
        """Atomically replace the engine (hot reload).  Queued requests
        are kept and served by the new engine from the next drain step."""
        with self._cv:
            self.engine = engine
            self.metrics.observe_reload()
            self._cv.notify_all()

    def queue_depth(self) -> int:
        with self._cv:
            return self._n_queued

    @contextlib.contextmanager
    def hold(self):
        """Hold the drain for the block: no step is taken, and other
        threads' submits wait, until it exits.  The holder's own submits
        queue, so a `swap_engine` (a hot reload) inside the block serves
        every one of them on the new engine."""
        with self._cv:
            yield self

    # -- draining ----------------------------------------------------------

    def _take_batch(self) -> tuple[
        ServingEngine, tuple[str, int], list[tuple[np.ndarray, ServingFuture]]
    ]:
        """Pop up to batch_size same-op requests + the engine to serve
        them with.  Caller must hold the lock; empty list if idle.

        Takes whole blocks only: a block that would not fit next to the
        requests already taken — or whose (op, k) differs from the
        blocks already taken — waits for the next step.  The single
        exception is a block larger than the batch itself, which is
        split at the front of an empty batch (unavoidable — callers who
        need the one-step guarantee keep blocks <= batch_size)."""
        engine = self.engine
        slots = engine.batch_size
        op = OP_PREDICT
        taken: list[tuple[np.ndarray, ServingFuture]] = []
        while self._queue and len(taken) < slots:
            blk_op, block = self._queue[0]
            if taken and blk_op != op:
                break  # never mix operations within one device step
            if len(taken) + len(block) <= slots:
                self._queue.popleft()
                taken.extend(block)
                op = blk_op
            elif not taken:
                taken.extend(block[:slots])
                self._queue[0] = (blk_op, block[slots:])
                op = blk_op
                break
            else:
                break
        self._n_queued -= len(taken)
        if taken:
            t_dequeue = time.perf_counter()
            for _, fut in taken:
                if fut.trace is not None:
                    fut.trace.t_dequeue = t_dequeue
        return engine, op, taken

    def _run_batch(
        self,
        engine: ServingEngine,
        op: tuple[str, int],
        taken: list[tuple[np.ndarray, ServingFuture]],
    ) -> None:
        slots = engine.batch_size
        self.metrics.observe_batch(len(taken), slots)
        try:
            # the taken rows go straight into the engine's staging rows,
            # the pad rows are zeroed; the engine is held for the step
            with engine.staged() as batch:
                for i, (image, _) in enumerate(taken):
                    batch[i] = image
                batch[len(taken):] = 0
                t_device_start = time.perf_counter()
                for _, fut in taken:
                    if fut.trace is not None:
                        fut.trace.t_device_start = t_device_start
                        fut.trace.step = engine.step
                with timed_block("batcher.device") as tb:
                    if op[0] == "search":
                        indices, dists = tb.sync(engine.search(batch, op[1]))
                        results = [(indices[i], dists[i]) for i in range(len(taken))]
                    else:
                        labels = tb.sync(engine.predict(batch))
                        results = [int(labels[i]) for i in range(len(taken))]
        except Exception as e:  # deliver the failure, keep serving
            for _, fut in taken:
                fut.t_done = time.perf_counter()
                self.metrics.observe_request(0.0, error=True)
                self._finish_request(fut, error=True)
                fut._resolve(None, e)
            return
        t_device_end = t_device_start + tb.elapsed_s
        # metrics/traces are recorded BEFORE the resolve wakes the waiter,
        # so a scrape issued after a response arrives never reads a
        # counter that has not seen that request yet
        for i, (_, fut) in enumerate(taken):
            if fut.trace is not None:
                fut.trace.t_device_end = t_device_end
            fut.t_done = time.perf_counter()
            self.metrics.observe_request(
                fut.latency_s(),
                exemplar=fut.trace.request_id if fut.trace is not None else None,
            )
            self._finish_request(fut)
            fut._resolve(results[i])

    def _finish_request(self, fut: ServingFuture, *, error: bool = False) -> None:
        """Record per-stage latencies and, for batcher-owned traces,
        finalize into the ring.  Transport-owned traces stay open — the
        HTTP server owns the response-write span and finalizes after the
        bytes are flushed."""
        trace = fut.trace
        if trace is None:
            return
        trace.t_resolve = fut.t_done
        t0, td = trace.t_submit, trace.t_dequeue
        tds, tde = trace.t_device_start, trace.t_device_end
        if td is not None:
            self.metrics.observe_stage("queue", td - t0)
        if tds is not None and td is not None:
            self.metrics.observe_stage("assembly", tds - td)
        if tde is not None and tds is not None:
            self.metrics.observe_stage("device", tde - tds)
        if trace.owner == OWNER_TRANSPORT:
            return
        entry = trace.finalize(error=error)
        if entry is not None and self.traces is not None:
            self.traces.append(entry)

    def step(self) -> int:
        """Serve one micro-batch synchronously; returns requests served."""
        with self._cv:
            engine, op, taken = self._take_batch()
        if taken:
            self._run_batch(engine, op, taken)
        return len(taken)

    def flush(self) -> int:
        """Drain the whole queue synchronously (no thread required)."""
        total = 0
        while True:
            n = self.step()
            if n == 0:
                return total
            total += n

    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait(0.05)
                if not self._running and not self._queue:
                    return
                # coalescing window: give a trickle of traffic a chance
                # to fill more slots before paying a device launch (loop
                # on a deadline — each submit notifies the condition, so
                # a single wait would collapse on the first arrival)
                deadline = time.perf_counter() + self.max_delay_s
                while (
                    self._running
                    and self._n_queued < self.engine.batch_size
                ):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                engine, op, taken = self._take_batch()
            if taken:
                self._run_batch(engine, op, taken)

    def start(self) -> "MicroBatcher":
        """Start the background drain thread (idempotent; reopens a
        stopped batcher)."""
        with self._cv:
            if self._running:
                return self
            self._running = True
            self._closed = False
            self._thread = threading.Thread(
                target=self._drain_loop, name="hdc-serve-drain", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop the drain thread; with `drain`, serve what is queued first.

        Idempotent and safe to race: submits are rejected the instant
        `_closed` is set (never silently dropped), and the thread handle
        is claimed under the lock so two concurrent `stop()` calls can't
        both join-and-clear it.
        """
        with self._cv:
            self._running = False
            self._closed = True
            thread, self._thread = self._thread, None
            if not drain:
                pending = [pair for _, block in self._queue for pair in block]
                self._queue.clear()
                self._n_queued = 0
                self.metrics.dropped(len(pending))
                for _, fut in pending:
                    fut._resolve(None, RuntimeError("server stopped"))
                    self._finish_request(fut, error=True)
            self._cv.notify_all()
        if thread is not None:
            thread.join()
        if drain:
            # a never-started (or already-joined) batcher still honours
            # the drain promise: serve whatever is left synchronously
            self.flush()
