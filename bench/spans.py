"""The program's own spans inside the harness's, over one traced stretch.

    python3 -m bench.spans --workload <name> --seed <n> --seconds <s>

From the root of a checkout, on a card.  Runs the cell once as
``bench/run.py --trace 1`` does and also records the program's spans
(``repro_torch.obs.profiler``: ``record_spans`` after the stretch's start
mark, ``take_spans`` before its stop mark).  Prints ``bench/run.py``'s
result line with one key more, ``split`` (:class:`Split`, every time a
step's mean over the stretch's steps):

- ``spans_dropped``: the spans the program's ring dropped over the
  stretch; past 0 every other field is null, since the ring kept only
  the stretch's tail and each sum would read low;
- ``idle_gaps``: the device's idle gaps named ``<harness span>/<innermost
  program span>`` where the host was in one, by the harness span alone
  otherwise; summed by the text before ``/`` they are the breakdown's;
- ``host_path_ms``: the self time of the program's spans other than the
  waits (:data:`WAITS`);
- ``device_wait_ms``: the time in the waits;
- ``program_idle_ms``: the device's idle time while a client thread was
  in a program span;
- ``harness_self_ms``: the harness spans' time outside the program's;
- ``block_ms``: the mean time of the stretch's steps;
- ``spans``: each program span's count, ms, self ms and idle ms a step;
- ``idle_covered``: the share of each harness span's idle time that lies
  in a program span;
- ``wait_lag_us``: the median over the waits of the time from the end of
  the device's last busy interval before a wait's end to that end.  The
  host learns that the device is done after it is: a lag below 0, or far
  above the tens of microseconds a wake-up takes, says the trace's device
  times sit off the host's clock, and the idle gaps' names with them;
- ``span_ns``: one span's enter and exit with recording off and on,
  loop included, on this host.

``run_cell`` builds its ``Stretch`` by name; this tool hands it
:class:`ProgramStretch` for the run.  ``bench/run.py`` records no
program span: `split` belongs in ``Stretch.reduce``, and this module
goes once it is there.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

from bench.tracing import DEVICE_CATS, OUTSIDE, Stretch, Summary, _union

ROOT = Path(__file__).resolve().parents[1]
#: the program's spans that wait for the device
WAITS = ("engine.wait", "store.wait")


@dataclasses.dataclass
class Split:
    """The fields of the module's docstring; every one but ``spans_dropped``
    None where the ring dropped spans, since its sums would then read low."""

    spans_dropped: int = 0
    idle_gaps: list | None = None
    host_path_ms: float | None = None
    device_wait_ms: float | None = None
    program_idle_ms: float | None = None
    harness_self_ms: float | None = None
    block_ms: float | None = None
    spans: dict | None = None
    idle_covered: dict | None = None
    wait_lag_us: float | None = None


def self_times(spans: list) -> list[int]:
    """Each span's self time in ns, in the order of `spans`
    (``profiler.Span``): its duration less the part its child spans (one
    deeper, inside it, on its thread) cover."""
    out = [s.t1_ns - s.t0_ns for s in spans]
    order = sorted(range(len(spans)), key=lambda i: (spans[i].thread, spans[i].t0_ns,
                                                     spans[i].depth))
    open_: list[int] = []  # the thread's spans enclosing the current one
    for i in order:
        s = spans[i]
        while open_ and (spans[open_[-1]].thread != s.thread
                         or spans[open_[-1]].t1_ns <= s.t0_ns
                         or spans[open_[-1]].depth >= s.depth):
            open_.pop()
        if open_ and spans[open_[-1]].depth == s.depth - 1:
            out[open_[-1]] -= s.t1_ns - s.t0_ns
        open_.append(i)
    return out


@dataclasses.dataclass
class SpanSummary(Summary):
    """A stretch's :class:`Summary`, its fields as ``Stretch.reduce`` gives
    them, and the program's spans split against the harness's."""

    split: Split = dataclasses.field(default_factory=Split)


def _overlap(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """ns where two sorted lists of disjoint intervals overlap."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class _Index:
    """Intervals ``(t0, t1, item)`` to find those holding an instant."""

    def __init__(self, items: list[tuple[int, int, object]]):
        self.items = sorted(items, key=lambda h: h[:2])
        self.starts = [h[0] for h in self.items]
        self.longest = max((t1 - t0 for t0, t1, _ in self.items), default=0)

    def holding(self, at: float) -> list[tuple[int, int, object]]:
        out = []
        for h in reversed(self.items[:bisect.bisect_right(self.starts, at)]):
            if h[0] < at - self.longest:
                break
            if at < h[1]:
                out.append(h)
        return out


def split(program: list, harness: list, steps: list, busy: list, lo: int, hi: int,
          dropped: int = 0) -> Split:
    """`program`: the program's spans (``profiler.Span``); `harness`: the
    harness's (name, t0, t1); `steps`: (t0, t1) of the window's steps;
    `busy`: the device's busy intervals, sorted and disjoint; [`lo`, `hi`):
    the stretch; `dropped`: the spans the ring lost.  Host
    ``perf_counter_ns`` throughout."""
    if dropped:
        return Split(spans_dropped=dropped)
    inside = [(t0, t1) for t0, t1 in steps if t0 >= lo and t1 <= hi]
    n = max(1, len(inside))
    gaps, at = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    prog = [s for s in program if s.t1_ns > lo and s.t0_ns < hi]
    host = [(t0, t1, name) for name, t0, t1 in harness if t1 > lo and t0 < hi]
    by_harness, by_program = _Index(host), _Index([(s.t0_ns, s.t1_ns, s) for s in prog])
    named: dict[str, float] = {}
    idle_of: dict[str, int] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        # the innermost harness span, the tie to the first name, as Stretch.reduce
        h = min(by_harness.holding(mid), key=lambda x: (x[1] - x[0], x[2]), default=None)
        p = max(by_program.holding(mid), key=lambda x: x[2].depth, default=None)
        name = h[2] if h else OUTSIDE
        if p is not None:
            name = f"{name}/{p[2].name}"
            idle_of[p[2].name] = idle_of.get(p[2].name, 0) + (b - a)
        named[name] = named.get(name, 0.0) + (b - a) / 1e9
    # per-step sums over the stretch's whole steps, from the first one's
    # start to the last one's end
    w0, w1 = min((t0 for t0, _ in inside), default=lo), max((t1 for _, t1 in inside), default=lo)
    own = [(s, o) for s, o in zip(prog, self_times(prog)) if s.t0_ns >= w0 and s.t1_ns <= w1]
    outer = _union([(s.t0_ns, s.t1_ns) for s, _ in own if s.depth == 0])
    held = _union([(max(t0, w0), min(t1, w1)) for t0, t1, _ in host if t1 > w0 and t0 < w1])
    steps_gaps = [(max(a, w0), min(b, w1)) for a, b in gaps if b > w0 and a < w1]
    per_name: dict[str, dict] = {}
    for s, o in own:
        e = per_name.setdefault(s.name, {"n": 0, "ms": 0.0, "self_ms": 0.0, "idle_ms": 0.0})
        e["n"] += 1
        e["ms"] += (s.t1_ns - s.t0_ns) / 1e6 / n
        e["self_ms"] += o / 1e6 / n
    for name, ns in idle_of.items():
        per_name[name]["idle_ms"] = ns / 1e6 / n
    for e in per_name.values():
        e["n"] /= n
    ends = [b for _, b in busy]
    lags = []
    for s, _ in own:
        if s.name in WAITS:
            i = bisect.bisect_left(ends, s.t1_ns)  # the first busy end at or after the wait's end
            if i < len(busy) and busy[i][0] < s.t1_ns:  # the device still busy there
                lags.append(s.t1_ns - busy[i][1])
            elif i:
                lags.append(s.t1_ns - ends[i - 1])
    covered = {}
    for name, s in named.items():
        base = name.split("/", 1)[0]
        tot, cov = covered.get(base, (0.0, 0.0))
        covered[base] = (tot + s, cov + (s if "/" in name else 0.0))
    return Split(
        idle_gaps=[[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])],
        host_path_ms=sum(o for s, o in own if s.name not in WAITS) / 1e6 / n,
        device_wait_ms=sum(s.t1_ns - s.t0_ns for s, _ in own if s.name in WAITS) / 1e6 / n,
        program_idle_ms=_overlap(steps_gaps, outer) / 1e6 / n,
        harness_self_ms=(sum(b - a for a, b in held) - _overlap(held, outer)) / 1e6 / n,
        block_ms=sum(t1 - t0 for t0, t1 in inside) / 1e6 / n,
        spans=per_name,
        idle_covered={k: cov / tot for k, (tot, cov) in covered.items() if tot > 0},
        wait_lag_us=statistics.median(lags) / 1e3 if lags else None,
    )


class ProgramStretch(Stretch):
    """The harness's stretch, the program's spans recorded inside it."""

    def start(self) -> None:
        from repro_torch.obs import profiler

        super().start()
        profiler.record_spans()

    def stop(self) -> None:
        from repro_torch.obs import profiler

        self.program, self.dropped = profiler.take_spans(), profiler.spans_dropped
        super().stop()

    def busy(self) -> list[tuple[int, int]]:
        """The device's busy intervals in the stretch, host ns, as
        ``Stretch.reduce`` takes them."""
        off = self._offset_ns()
        dev = []
        for e in self.events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a = float(e["ts"]) * 1e3 - off
            b = a + float(e.get("dur", 0)) * 1e3
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                dev.append((a, b))
        return _union(dev)

    def reduce(self, spans: list, steps: list, step_least_s: float) -> SpanSummary:
        summary = super().reduce(spans, steps, step_least_s)
        parts = split(self.program, spans, steps, self.busy(), self.t0, self.t1, self.dropped)
        return SpanSummary(**vars(summary), split=parts)


def span_ns(n: int = 60_000) -> dict:
    """ns of one span's enter and exit with recording off and on, loop
    included (`n` spans each, within the ring)."""
    from repro_torch.obs import profiler as rec

    out = {}
    for mode in ("off", "on"):
        if mode == "on":
            rec.record_spans()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with rec.span(mode):
                pass
        out[mode] = (time.perf_counter_ns() - t0) / n
    rec.take_spans()
    return out


def traced_run(cell, seed: int, seconds: float, device, started: float, clock=time.monotonic):
    """``harness.run_cell`` with ``trace`` on and the program's spans recorded."""
    from bench import harness

    with mock.patch.object(harness, "Stretch", ProgramStretch):
        return harness.run_cell(cell, seed, seconds, True, device, started, clock=clock)


def main(argv=None) -> int:
    from bench import run

    started = run.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src")]
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda-cache"))
    from bench.cells import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = traced_run(cell, args.seed, args.seconds, device, started, clock=run.boot_clock)
    s = out["summary"]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"], "busy_s": s.busy_s,
           "window_s": s.window_s}
    line = run.result_line(cell, out, dev, True)
    line["split"] = dict(dataclasses.asdict(s.split), span_ns=span_ns())
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
