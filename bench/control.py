"""The control of a cell's comparison: the reference in the program's place,
reading the images in bfloat16, the precision below the float32 that the
configurations state.  Its answers go through the same judgement as the
program's, and it has to come out as not correct.

    python bench/control.py --workload <name> --seeds <n> [<n> ...]

Prints one JSON line a seed: the numbers compared and whether they pass.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_checks(cell, seed: int, device) -> dict:
    """The judgement of the control's answers for one seed."""
    import torch

    entry = cell.entry_class()(cell, seed, device)
    entry.setup()
    entry.keep()
    entry.free()
    answers = entry.control(entry.reference(torch.bfloat16))
    return entry.judge(answers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.cells import load_cell
    from bench.entries import passed

    if not torch.cuda.is_available():
        print("the control runs at the cell's size on a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        checks = control_checks(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed, "checks": checks,
                          "passed": passed(checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
