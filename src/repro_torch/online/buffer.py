"""`FeedbackBuffer`: the bounded ingest queue of the online-learning loop.

A copy of ``repro.online.buffer`` (stdlib and numpy only): the same
admission, shedding and drain order as the JAX package's.

The HTTP `:feedback` route runs on the server's event loop — it must
*never* block on the learner, and overload must degrade loudly instead
of growing an unbounded backlog (the same admission philosophy as the
predict path's `QueueFull` -> 429).  The buffer therefore:

  * bounds itself in **examples**, not blocks — capacity means the same
    thing whatever chunk size clients POST;
  * admits a block all-or-nothing: a feedback block that does not fit
    is shed whole (``n_shed`` counts the examples) so the training
    stream never contains a silently-truncated prefix of a request;
  * hands the learner examples strictly in arrival order — `drain`
    splits a block when it straddles the requested maximum, but never
    reorders — so the accumulated class sums are bit-identical to
    offline ``partial_fit`` on the same stream (integer bundling is
    order-independent, but order preservation keeps ``n_seen``-based
    staleness accounting and any future replay log honest.)

All methods are thread-safe; `drain` is the only one that waits (the
learner thread parks on the condition until feedback arrives or the
buffer closes).
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np


class FeedbackBuffer:
    """Bounded FIFO of labeled example blocks between ingest and learner."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        # (images, labels, t_put): blocks carry their admission time so
        # the learner can report ingest wait (put -> drain) honestly
        self._blocks: collections.deque[
            tuple[np.ndarray, np.ndarray, float]
        ] = collections.deque()
        self._n = 0  # queued examples (sum over blocks)
        self._cv = threading.Condition()
        self._closed = False
        # counters (read via snapshot(); ints only)
        self.n_ingested = 0  # examples accepted into the buffer, ever
        self.n_shed = 0  # examples refused because the buffer was full
        #: put time (perf_counter) of the oldest example returned by the
        #: most recent successful `drain` — the learner's ingest-wait and
        #: feedback-to-publish measurements anchor here
        self.last_drained_oldest_t: float | None = None

    # -- ingest (server/event-loop side; never blocks) ---------------------

    def put(self, images: np.ndarray, labels: np.ndarray) -> bool:
        """Admit one ``(n, H) float32 / (n,) int32`` block, all-or-nothing.

        Returns False (and counts the block into ``n_shed``) when the
        block does not fit under ``capacity``.  Raises RuntimeError on a
        closed buffer — the transport maps that to 503, not 429, so a
        shutting-down learner is distinguishable from overload.
        """
        images = np.asarray(images, np.float32)
        labels = np.asarray(labels, np.int32)
        if images.ndim != 2 or labels.shape != (len(images),):
            raise ValueError(
                f"feedback block must be (n, H) images + (n,) labels, got "
                f"{images.shape} / {labels.shape}"
            )
        n = len(images)
        if n == 0:
            return True
        with self._cv:
            if self._closed:
                raise RuntimeError("feedback buffer is closed; block rejected")
            if self._n + n > self.capacity:
                self.n_shed += n
                return False
            self._blocks.append((images, labels, time.perf_counter()))
            self._n += n
            self.n_ingested += n
            self._cv.notify_all()
        return True

    # -- drain (learner side) ----------------------------------------------

    def drain(
        self,
        max_examples: int | None = None,
        timeout: float | None = None,
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Pop up to ``max_examples`` in arrival order, concatenated.

        Blocks until feedback arrives, ``timeout`` elapses (-> None), or
        the buffer closes (-> whatever remains, else None).  A block
        straddling the maximum is split, its tail staying queued at the
        front — no example is reordered or lost.
        """
        with self._cv:
            if not self._blocks and not self._closed:
                self._cv.wait(timeout)
            if not self._blocks:
                return None
            xs, ys, taken = [], [], 0
            oldest_t: float | None = None
            while self._blocks:
                x, y, t_put = self._blocks[0]
                room = None if max_examples is None else max_examples - taken
                if room is not None and room <= 0:
                    break
                if room is not None and len(x) > room:
                    # the split tail keeps its original put time: those
                    # examples have been waiting since that put
                    self._blocks[0] = (x[room:], y[room:], t_put)
                    x, y = x[:room], y[:room]
                else:
                    self._blocks.popleft()
                if oldest_t is None:
                    oldest_t = t_put  # FIFO: the first block is the oldest
                xs.append(x)
                ys.append(y)
                taken += len(x)
            self._n -= taken
            if xs:
                self.last_drained_oldest_t = oldest_t
        if not xs:
            return None
        return np.concatenate(xs), np.concatenate(ys)

    # -- lifecycle / introspection ----------------------------------------

    def close(self) -> None:
        """Refuse further puts and wake any parked drain.  Queued blocks
        stay drainable (the learner's final flush reads them out)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def reopen(self) -> None:
        with self._cv:
            self._closed = False

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def depth(self) -> int:
        """Examples currently queued (gauge)."""
        with self._cv:
            return self._n

    def snapshot(self) -> dict:
        with self._cv:
            return {
                "capacity": int(self.capacity),
                "depth": int(self._n),
                "n_ingested": int(self.n_ingested),
                "n_shed": int(self.n_shed),
            }
