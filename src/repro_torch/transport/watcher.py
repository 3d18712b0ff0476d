"""`ReloadWatcher`: the background promotion half of the lifecycle story.

The torch counterpart of ``repro.transport.watcher``.  One daemon thread
per registry entry polls `CheckpointManager.poll_latest` (through
`ModelRegistry.hot_reload`, which encapsulates the poll + build + warm
+ swap contract) on a fixed interval, so a serving fleet follows the
trainer's published steps with no operator in the path.

Because `hot_reload` loads whatever the newest atomically-published
checkpoint *is* — the restored config dictates the encoder — the
watcher auto-promotes `HDCModel.convert`-ed table -> `uhd_dynamic`
checkpoints too: publish the converted artifact and every watching
server migrates to the small codebook without a restart.

On a card the promotion warms the new engine on the watcher's thread,
which captures its CUDA graph on the engine's own stream while the
drain thread replays the old engine's graph and an `OnlineLearner` may
train on its own stream (`repro_torch.serving.engine`).

The watcher attaches itself to the registry on `start()` so
`ModelRegistry.shutdown()` stops it *before* draining the batcher — a
promotion can never race the drain.
"""

from __future__ import annotations

import threading
import time

from repro_torch.obs.histogram import LatencyHistogram
from repro_torch.serving.registry import ModelRegistry


class ReloadWatcher:
    """Poll-and-promote thread for one `ModelRegistry` entry."""

    def __init__(
        self,
        registry: ModelRegistry,
        name: str,
        *,
        interval_s: float = 2.0,
        on_promote=None,
    ):
        self._registry = registry
        self.name = name
        self.interval_s = float(interval_s)
        self._on_promote = on_promote
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # observability (read by /healthz and tests)
        self.n_polls = 0
        self.n_promotions = 0
        self.n_errors = 0
        self.last_step: int | None = None
        self.last_error: BaseException | None = None
        self.promote_hist = LatencyHistogram()  # load + warm + swap time
        self.last_promote_ms: float | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReloadWatcher":
        """Attach to the registry and start polling.  Idempotent, and a
        stopped watcher restarts (its registry attachment survives
        `stop()`, so re-attach is skipped when it is still ours)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            if self._registry.watcher(self.name) is not self:
                self._registry.attach_watcher(self.name, self)
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"hdc-reload-watch-{self.name}", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, *, join: bool = True) -> None:
        """Idempotent; called by `ModelRegistry.shutdown`/`unregister`
        before the batcher drains."""
        self._stop_event.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if join and thread is not None and thread is not threading.current_thread():
            thread.join()

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    # -- polling -----------------------------------------------------------

    def poll_once(self) -> int | None:
        """One poll/promote cycle; returns the promoted step or None.

        Never raises: a failed load (e.g. a checkpoint published by a
        newer trainer mid-write on a non-atomic filesystem) is counted
        and retried next interval — the live engine keeps serving.
        """
        self.n_polls += 1
        t0 = time.perf_counter()
        try:
            step = self._registry.hot_reload(self.name)
        except KeyError:
            # entry unregistered under us: nothing left to watch
            self._stop_event.set()
            return None
        except Exception as e:
            self.n_errors += 1
            self.last_error = e
            return None
        if step is not None:
            elapsed = time.perf_counter() - t0
            self.n_promotions += 1
            self.last_step = step
            self.promote_hist.observe(elapsed)
            self.last_promote_ms = elapsed * 1e3
            traces = getattr(self._registry, "traces", None)
            if traces is not None:
                # t_mono = promotion *start*: every span served by the
                # new engine has t_device_start after this mark
                traces.record_event(
                    "promotion",
                    model=self.name,
                    step=int(step),
                    duration_ms=elapsed * 1e3,
                    t_mono=t0,
                )
            if self._on_promote is not None:
                try:
                    self._on_promote(self.name, step)
                except Exception:  # observer hooks must not stop the watcher
                    pass
        return step

    def _run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            self.poll_once()

    def describe(self) -> dict:
        return {
            "name": self.name,
            "interval_s": self.interval_s,
            "running": self.running(),
            "n_polls": int(self.n_polls),
            "n_promotions": int(self.n_promotions),
            "n_errors": int(self.n_errors),
            "last_step": self.last_step,
            "last_promote_ms": self.last_promote_ms,
        }
