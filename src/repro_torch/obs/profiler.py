"""Device-step profiling hooks: wall timing + opt-in torch.profiler traces.

The torch counterpart of ``repro.obs.profiler``.  `timed_block` is the
cheap, always-on half: a context manager that times a block and (when
asked) waits for the CUDA work behind its outputs first, so the measured
interval covers the device's execution, not the enqueue:

    with timed_block() as tb:
        labels = tb.sync(engine.predict(batch))
    metrics.observe_stage("device", tb.elapsed_s)

The wait is an event recorded on the current stream, never a
device-wide ``torch.cuda.synchronize()``: another thread may be
capturing a CUDA graph on its own stream, and a device-wide wait would
break that capture.

`profile_capture` is the heavyweight, opt-in half: a bounded
`torch.profiler` window written to a directory as a Chrome trace
(viewable with Perfetto), one capture at a time.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import torch

_capture_lock = threading.Lock()


def _cuda_tensors(out) -> list[torch.Tensor]:
    """The CUDA tensors inside `out` (a tensor, or nested tuples, lists
    and dict values of them; anything else passes)."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_cuda else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _cuda_tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _cuda_tensors(o)]
    return []


class timed_block:
    """Context manager: ``elapsed_s`` wall time of the block, after
    waiting on any CUDA output handed to :meth:`sync`."""

    __slots__ = ("label", "elapsed_s", "_t0")

    def __init__(self, label: str = ""):
        self.label = label
        self.elapsed_s = 0.0

    def __enter__(self) -> "timed_block":
        self._t0 = time.perf_counter()
        return self

    def sync(self, out):
        """Wait until the CUDA work of `out` (numpy and CPU tensors pass
        through) is done, by an event on each device's current stream,
        then return `out` unchanged."""
        for dev in {t.device for t in _cuda_tensors(out)}:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            done.synchronize()
        return out

    def __exit__(self, *exc) -> None:
        self.elapsed_s = time.perf_counter() - self._t0


def profile_capture(out_dir: str, ms: float) -> str:
    """Trace the process with ``torch.profiler`` (CPU, and CUDA where a
    card is present) for ``ms`` milliseconds and write the Chrome trace
    into ``out_dir``; returns the directory.  One capture at a time:
    concurrent calls raise RuntimeError instead of corrupting the
    trace."""
    from torch.profiler import ProfilerActivity, profile

    if not _capture_lock.acquire(blocking=False):
        raise RuntimeError("a profile capture is already in progress")
    try:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            time.sleep(max(0.0, float(ms)) / 1e3)
        prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))
    finally:
        _capture_lock.release()
    return str(out_dir)
