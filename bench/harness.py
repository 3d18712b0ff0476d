"""One run of one cell: set-up, the timed window, the judgement, the result.

Closed loops: each of the traffic's clients runs on a thread of its own
and hands the entry its next block (or job) as soon as the last one has
answered, until the window's time is up; the blocks are drawn from the
seed, one stream a client.  The window runs from the first block handed
over to the last answer, and its rates are all the images answered over
all that time.  Set-up ends with :data:`WARMUP_STEPS` steps of the
cell's own shape.  With ``trace`` the profiler runs over one stretch of
the window (from a quarter of it on, :data:`TRACE_SECONDS` long, at most
half of it), and the per-layer readers take that stretch.

The window's threads run on two cores of the process's set (its last two):
host copies and launches then keep their caches, and a run's rate varies
far less from run to run.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time

import numpy as np
import torch

from bench.entries import Spans, passed
from bench.tracing import Stretch

#: steps of the cell's own shape run at the end of set-up
WARMUP_STEPS = 3
#: seconds the profiler traces in a ``--trace 1`` run, at most half the window
TRACE_SECONDS = 2.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Client(threading.Thread):
    def __init__(self, entry, index: int, done: threading.Event, seed: int):
        super().__init__(name=f"bench-client-{index}", daemon=True)
        self.entry, self.done = entry, done
        self.rng = np.random.default_rng([seed, 2, index])
        self.spans = Spans()
        self.records: list[tuple[int, int, int, object]] = []  # blk, t0, t1, answer
        self.errors: list[str] = []
        #: held through each step, so that holding it waits for the step to end
        self.stepping = threading.Lock()

    def run(self) -> None:
        n = self.entry.n_blocks()
        while not self.done.is_set():
            blk = int(self.rng.integers(0, n))
            with self.stepping:
                t0 = time.perf_counter_ns()
                try:
                    out = self.entry.step(blk, self.spans)
                except Exception as exc:  # counted as failed; the run is not correct
                    self.errors.append(f"{type(exc).__name__}: {exc}")
                    return
                self.records.append((blk, t0, time.perf_counter_ns(), out))


def _start_idle(stretch: Stretch, clients: list, device: torch.device) -> None:
    """Start the profiler with every client between two steps and the
    device idle: started while a kernel runs, it lost every kernel record
    of the stretch in half of the search cell's traced runs on the card."""
    with contextlib.ExitStack() as held:
        for c in clients:
            held.enter_context(c.stepping)
        _sync(device)
        stretch.start()


def run_cell(cell, seed: int, seconds: float, trace: bool, device: torch.device,
             started: float, clock=time.monotonic) -> dict:
    """Run `cell` once.  `started` is the process's start on `clock`;
    set-up runs from it to the first timed block."""
    entry = cell.entry_class()(cell, seed, device)
    entry.setup()
    stretch = Stretch(device) if trace else None
    if stretch is not None:
        stretch.prepare()
    warm = Spans()
    for i in range(WARMUP_STEPS):
        entry.step(i % entry.n_blocks(), warm)
    _sync(device)
    setup_s = clock() - started

    cpus = os.sched_getaffinity(0)
    os.sched_setaffinity(0, sorted(cpus)[-2:])  # inherited by the clients
    gc.collect()
    gc.freeze()  # the set-up's objects out of the window's collections
    done = threading.Event()
    start = time.perf_counter_ns()
    clients = [_Client(entry, i, done, seed) for i in range(entry.clients)]
    for c in clients:
        c.start()
    if stretch is not None:
        time.sleep(seconds / 4)
        _start_idle(stretch, clients, device)
        time.sleep(min(TRACE_SECONDS, seconds / 2))
        stretch.stop()
    time.sleep(max(0.0, start / 1e9 + seconds - time.perf_counter_ns() / 1e9))
    done.set()
    for c in clients:
        c.join()
    os.sched_setaffinity(0, cpus)
    records = [r for c in clients for r in c.records]
    errors = [e for c in clients for e in c.errors]
    end = max((r[2] for r in records), default=time.perf_counter_ns())
    window_s = (end - start) / 1e9
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    summary = None
    if stretch is not None:
        summary = stretch.reduce(
            [s for c in clients for s in c.spans.items],
            [(r[1], r[2]) for r in records], entry.work().least_s)
    entry.keep()
    entry.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = entry.judge([(r[0], r[3]) for r in records])
    n_done = len(records)
    return {
        "correct": passed(checks) and not errors,
        "attempted": n_done + len(errors),
        "failed": len(errors),
        "errors": errors,
        "setup_s": setup_s,
        "window_s": window_s,
        "images": n_done * entry.images_per_step,
        "memory_peak_bytes": int(peak),
        "summary": summary,
        "checks": checks,
    }
