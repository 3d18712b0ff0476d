"""The program's spans over one cell's set-up.

    python3 -m bench.setup_spans --workload <name> --seed <n>

From the root of a checkout, on a card.  Builds the cell's entry, runs its
``setup`` and the harness's warm-up steps with the program's spans
recorded (``repro_torch.obs.profiler``), and prints one JSON line:

- ``before_s``: from the process's start to the recording's, the
  imports and the card's context (``bench/run.py``'s clock);
- ``setup_ms``: the recorded set-up, the card synchronised at its end;
- ``spans``: each span's count, ms and self ms over the set-up
  (``bench.spans.self_times``);
- ``outside_ms``: the set-up's time outside every outermost span;
- ``spans_dropped``: past 0, the sums read low;
- ``span_ns``: one span's enter and exit with recording off and on
  (``bench.spans.span_ns``);
- ``device``: the card and the set-up's peak memory.

``bench.spans`` records over the window's traced stretch alone, so the
set-up's spans (``sobol.directions``, ``model.fit``) are read here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def setup_split(cell, seed: int, device) -> dict:
    """`cell`'s set-up and warm-up under the program's spans."""
    from bench import harness
    from bench.entries import Spans
    from bench.spans import self_times
    from bench.tracing import _union
    from repro_torch.obs import profiler

    profiler.record_spans()
    t0 = time.perf_counter_ns()
    try:
        entry = cell.entry_class()(cell, seed, device)
        entry.setup()
        warm = Spans()
        for i in range(harness.WARMUP_STEPS):
            entry.step(i % entry.n_blocks(), warm)
        harness._sync(device)
    finally:
        t1 = time.perf_counter_ns()
        spans, dropped = profiler.take_spans(), profiler.spans_dropped
    entry.free()
    per: dict[str, dict] = {}
    for s, own in zip(spans, self_times(spans)):
        e = per.setdefault(s.name, {"n": 0, "ms": 0.0, "self_ms": 0.0})
        e["n"] += 1
        e["ms"] += (s.t1_ns - s.t0_ns) / 1e6
        e["self_ms"] += own / 1e6
    outer = _union([(max(s.t0_ns, t0), min(s.t1_ns, t1)) for s in spans if s.depth == 0])
    return {"setup_ms": (t1 - t0) / 1e6, "spans": per, "spans_dropped": dropped,
            "outside_ms": (t1 - t0 - sum(b - a for a, b in outer)) / 1e6}


def main(argv=None) -> int:
    from bench import run
    from bench.spans import span_ns

    started = run.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src")]
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda-cache"))
    from bench.cells import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program, imported before the recording)

    device = torch.device("cuda", 0)
    torch.cuda.init()
    before_s = run.boot_clock() - started
    out = {"workload": cell.name, "seed": args.seed, "before_s": before_s,
           **setup_split(cell, args.seed, device), "span_ns": span_ns(),
           "device": {"kind": torch.cuda.get_device_name(0),
                      "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}}
    print(json.dumps(out, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
