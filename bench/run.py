"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``.  It needs as
many CUDA cards as the cell asks for and exits 2 without them, printing
no result.  The last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with its limit; the checks are also the last lines on
standard error.  It exits 3, printing no result, if the JAX package or
JAX was imported in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on :func:`boot_clock` (Linux: ``/proc/self/stat``
    counts it in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return min(ticks / os.sysconf("SC_CLK_TCK"), boot_clock())


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell, out: dict, device: dict, trace: bool) -> dict:
    from bench.cells import metric_reader

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(cell.root, m["name"])(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        s = out["summary"]
        line["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    line["checks"] = checks(out["checks"])
    return line


def checks(numbers: dict) -> dict:
    """Each number compared, with its limit (``bench.entries.bound``)."""
    from bench.entries import bound

    return {k: {"value": v, **bound(k)} for k, v in numbers.items()}


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda-cache"))
    from bench.cells import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program; fails without src/repro_torch)

    from bench.harness import run_cell

    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, started,
                   clock=boot_clock)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were imported: {found}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"] = out["summary"].busy_s
        dev["window_s"] = out["summary"].window_s
    line = result_line(cell, out, dev, bool(args.trace))
    from repro_torch.kernels._build import build_info

    if build_info:
        how = "found built" if build_info.get("cached") else f"built in {build_info['seconds']:.1f} s"
        print(f"kernel library: {how} (part of setup_s)", file=sys.stderr)
    for err in out["errors"][:3]:
        print(f"error: {err}", file=sys.stderr)
    for k, v in line["checks"].items():
        bound = f"limit {v['limit']}" if "limit" in v else f"at least {v['min']}"
        print(f"check {k} = {v['value']} ({bound})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
