"""Device-step profiling hooks: spans, wall timing, opt-in torch.profiler traces.

The torch counterpart of ``repro.obs.profiler``.  `span` names a stretch
of host code.  Spans are recorded only between :func:`record_spans` and
:func:`take_spans`; otherwise entering one costs a test of a module
flag and makes no torch call.  Each recorded span is one entry of a
bounded ring the module owns, ``(name, thread, depth, t0_ns, t1_ns)``
on ``time.perf_counter_ns``: ``thread`` is the native thread id (the
``tid`` of torch's Chrome trace), ``depth`` the number of recorded spans
the thread was inside when it entered.  Past :data:`SPAN_RING` entries
the oldest are dropped and counted in :data:`spans_dropped`.

`timed_block` is a span that always times itself: a context manager
that times a block and (when asked) waits for the CUDA work behind its
outputs first, so the measured interval covers the device's execution,
not the enqueue; its label is its span's name:

    with timed_block("batcher.device") as tb:
        labels = tb.sync(engine.predict(batch))
    metrics.observe_stage("device", tb.elapsed_s)

The wait is an event recorded on the current stream, never a
device-wide ``torch.cuda.synchronize()``: another thread may be
capturing a CUDA graph on its own stream, and a device-wide wait would
break that capture.

`profile_capture` is the heavyweight, opt-in half: a bounded
`torch.profiler` window written to a directory as a Chrome trace
(viewable with Perfetto), with the spans recorded over the window as
``"X"`` events on the trace's clock and the count the ring dropped,
one capture at a time.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

#: entries the span ring holds; older ones are dropped past it
SPAN_RING = 65536
#: spans dropped from the ring since the last :func:`record_spans`
spans_dropped = 0

_capture_lock = threading.Lock()
_recording = False
_ring: collections.deque = collections.deque(maxlen=SPAN_RING)
_ring_lock = threading.Lock()
_threads = threading.local()


class Span(NamedTuple):
    """One recorded span: host ``perf_counter_ns`` times."""

    name: str
    thread: int
    depth: int
    t0_ns: int
    t1_ns: int


def record_spans() -> None:
    """Empty the ring and record spans until :func:`take_spans`.  One
    recording at a time: a second raises RuntimeError."""
    global _recording, spans_dropped
    with _ring_lock:
        if _recording:
            raise RuntimeError("spans are already being recorded")
        _ring.clear()
        spans_dropped = 0
        _recording = True


def take_spans() -> list[Span]:
    """Stop recording and return the spans that ended while it was on,
    in the order they ended (spans still open are not recorded)."""
    global _recording
    with _ring_lock:
        _recording = False
        out = [Span._make(e) for e in _ring]
        _ring.clear()
    return out


def _thread() -> list:
    """This thread's [span depth, native id]."""
    st = getattr(_threads, "st", None)
    if st is None:
        st = _threads.st = [0, threading.get_native_id()]
    return st


class _Off:
    """Every span while none is recorded: enters and exits, and does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    """One span being recorded."""

    __slots__ = ("name", "_st", "_depth", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        st = self._st = _thread()
        self._depth = st[0]
        st[0] += 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global spans_dropped
        t1 = time.perf_counter_ns()
        self._st[0] = self._depth
        with _ring_lock:
            if not _recording:
                return
            if len(_ring) == SPAN_RING:
                spans_dropped += 1
            _ring.append((self.name, self._st[1], self._depth, self._t0, t1))


def span(name: str):
    """Context manager: records the block as the span `name` while spans
    are being recorded; otherwise one shared context that does nothing."""
    return _Span(name) if _recording else _OFF


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
    waiting on any CUDA output handed to :meth:`sync`; recorded as the
    span `label` where it has one."""

    __slots__ = ("label", "elapsed_s", "_span", "_t0")

    def __init__(self, label: str = ""):
        self.label = label
        self.elapsed_s = 0.0

    def __enter__(self) -> "timed_block":
        self._span = span(self.label) if self.label else _OFF
        self._span.__enter__()
        self._t0 = time.perf_counter_ns()
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
        self.elapsed_s = (time.perf_counter_ns() - self._t0) / 1e9
        self._span.__exit__(*exc)


def _clock_mark(marks: list, tag: str) -> None:
    """A ``perf_counter_ns`` reading inside a profiler range named for it:
    the range's trace time less the reading puts host times on the
    trace's clock."""
    with torch.profiler.record_function(f"repro_torch.clock.{tag}"):
        marks.append((f"repro_torch.clock.{tag}", time.perf_counter_ns()))


def _add_spans(path: Path, spans: list[Span], dropped: int, marks: list) -> None:
    """Write `spans` into the Chrome trace at `path` as ``"X"`` events of
    this process's threads, on the trace's clock, and the count of those
    the ring `dropped` as the global instant ``repro_torch.spans_dropped``
    at the capture's start: past 0, the spans begin later than the
    capture."""
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    at = {e["name"]: float(e["ts"]) * 1e3 for e in events if e.get("ph") == "X"
          and str(e.get("name", "")).startswith("repro_torch.clock.")}
    offsets = [at[name] - ns for name, ns in marks if name in at]
    if not offsets:
        raise RuntimeError("the trace holds neither clock mark of the capture")
    off = sum(offsets) / len(offsets)
    pid = os.getpid()
    events.extend(
        {"ph": "X", "cat": "repro_torch.span", "name": s.name, "pid": pid, "tid": s.thread,
         "ts": (s.t0_ns + off) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3,
         "args": {"depth": s.depth}}
        for s in spans)
    events.append({"ph": "i", "s": "g", "cat": "repro_torch.span",
                   "name": "repro_torch.spans_dropped", "pid": pid, "tid": 0,
                   "ts": min(at.values()) / 1e3, "args": {"count": dropped}})
    path.write_text(json.dumps(trace))


def profile_capture(out_dir: str, ms: float) -> str:
    """Trace the process with ``torch.profiler`` (CPU, and CUDA where a
    card is present) for ``ms`` milliseconds, recording spans over the
    same window, and write the Chrome trace, spans included, into
    ``out_dir``; returns the directory.  One capture at a time:
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
        marks: list = []
        with profile(activities=activities) as prof:
            _clock_mark(marks, "start")
            record_spans()
            try:
                time.sleep(max(0.0, float(ms)) / 1e3)
            finally:
                spans, dropped = take_spans(), spans_dropped
            _clock_mark(marks, "stop")
        path = out / f"trace_{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        _add_spans(path, spans, dropped, marks)
    finally:
        _capture_lock.release()
    return str(out_dir)
