"""The traced stretch of a ``--trace 1`` run, and its reduction.

``torch.profiler`` (CPU and CUDA activities) runs over one steady stretch
inside the window, over every thread (the clients run on threads of
their own).  Its trace is read from the exported Chrome trace: the device's
kernels, copies and fills, each an interval.  The harness's own spans are
host ``perf_counter_ns`` intervals recorded by the client threads; two
marks recorded inside ``record_function`` ranges put the two clocks on
one axis.

From that the stretch gives: its wall time; the device's busy time (the
union of kernel, copy and fill intervals); the summed time of its kernels
(copies and fills left out); the ten device operations that took most
time; and the device's idle gaps, each put to the harness span the host
was in at the gap's middle ("outside the entry" where it was in none).
"""

from __future__ import annotations

import bisect
import json
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
OUTSIDE = "outside the entry"


@dataclass
class Summary:
    """What one traced stretch shows; the per-layer readers take it."""

    window_s: float
    busy_s: float
    kernel_s: float
    steps: int
    least_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    block_ms: list = field(default_factory=list)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Stretch:
    """The profiler over one stretch of the window, started and stopped
    on one thread while the clients run on theirs."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: list[int] = []
        self.t0 = self.t1 = 0
        #: from the call that starts the profiler to the return of the one
        #: that stops it: steps overlapping it are slowed by the profiler
        self.call0 = self.call1 = 0

    def _mark(self, tag: str) -> None:
        with torch.profiler.record_function(f"bench.clock.{tag}"):
            self.marks.append(time.perf_counter_ns())

    def _profile(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))

    def prepare(self) -> None:
        """One short session at set-up: the first start of the profiler in a
        process loads and initialises its tracer, which takes seconds on the
        card and would hold up the clients inside the window."""
        with self._profile():
            torch.zeros(8, device=self.device).sum().item()

    def start(self) -> None:
        self.call0 = time.perf_counter_ns()
        self.prof = self._profile()
        self.prof.start()
        self._mark("start")
        self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self.t1 = time.perf_counter_ns()
        self._mark("stop")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.call1 = time.perf_counter_ns()

    def _read(self) -> None:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            self.events = json.loads(path.read_text())["traceEvents"]

    def _offset_ns(self) -> float:
        """trace ns - perf_counter ns, from the two marks."""
        ts = {e["name"]: float(e["ts"]) * 1e3 for e in self.events
              if str(e.get("name", "")).startswith("bench.clock.")}
        pairs = [(ts[f"bench.clock.{t}"], m) for t, m in zip(("start", "stop"), self.marks)
                 if f"bench.clock.{t}" in ts]
        if not pairs:
            raise RuntimeError("the trace holds neither clock mark of the stretch")
        return sum(a - m for a, m in pairs) / len(pairs)

    def reduce(self, spans: list, steps: list, step_least_s: float) -> Summary:
        """`spans`: (name, t0, t1) host spans of every client; `steps`:
        (t0, t1) of every step of the window, host ns."""
        self._read()
        off = self._offset_ns()
        lo, hi = self.t0, self.t1
        dev, kern_ns, by_name = [], 0, {}
        for e in self.events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a = float(e["ts"]) * 1e3 - off
            b = a + float(e.get("dur", 0)) * 1e3
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            dev.append((a, b))
            if e["cat"] == "kernel":
                kern_ns += b - a
            name = str(e["name"])[:100]
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        busy = _union(dev)
        gaps, at = [], lo
        for a, b in busy + [(hi, hi)]:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        host = sorted((t0, t1, n) for n, t0, t1 in spans if t1 > lo and t0 < hi)
        starts = [h[0] for h in host]
        longest = max((t1 - t0 for t0, t1, _ in host), default=0)
        idle: dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inside = []
            for t0, t1, n in reversed(host[:bisect.bisect_right(starts, mid)]):
                if t0 < mid - longest:
                    break
                if mid < t1:
                    inside.append((t1 - t0, n))
            name = min(inside)[1] if inside else OUTSIDE
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
        n_steps = sum(1 for t0, t1 in steps if t0 >= lo and t1 <= hi)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return Summary(
            window_s=(hi - lo) / 1e9, busy_s=sum(b - a for a, b in busy) / 1e9,
            kernel_s=kern_ns / 1e9, steps=n_steps, least_s=n_steps * step_least_s,
            device_ops=[[n, s] for n, s in top],
            idle_gaps=[[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
            block_ms=[(t1 - t0) / 1e6 for t0, t1 in steps
                      if t1 <= self.call0 or t0 >= self.call1],
        )
