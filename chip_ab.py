#!/usr/bin/env python3
"""A/B of the port's CUDA kernels between two checkouts, on one card, in one call.

    git archive <commit> src/repro_torch | tar -x -C build/parent   # a git-ignored directory
    python3 chip_ab.py build/parent [--rounds 2] [--only hamming_packed,bundle_binarize]

Each side runs in a process of its own that imports its own ``repro_torch``
(from ``<root>/src``) and builds its own kernels (into ``<root>/build``).  The
sides alternate, other then this, then this then other, for each round, so
that drift on the card falls on both.  A worker calls the public wrappers
(``repro_torch.kernels.ops``) at the main paths' shapes on inputs made from a
fixed seed, holds each result against its plain version, and times it with
``chip_smoke.device_ms`` (``torch.profiler``, 20 calls, a profile that missed
launches taken again), by kernel name.  ``hamming_topk_tensor`` runs kernel 5
with its large-store path (the one ``ops.topk_path`` picks past
``ops.TOPK_WARP_MAX_ROWS`` rows in each tree) forced at a shape it sends to the
warp path, to price the warp path against it; ``hamming_packed_<path>`` runs kernel 6
with that path forced (``ops.packed_path``; a tree without it runs its one
kernel).  ``--only a,b`` keeps the cases whose names start with one of those
prefixes.  Printed:
the card's ``nvidia-smi`` name and power limit, one JSON line per side, round
and case, then one summary line per case with each side's mean device ms and
the ratio this / other.  Exits non-zero without a card or if any output
differs from its plain version.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (case, shape): the shapes the main paths launch (chip_smoke.py's kernels line)
CASES = [
    ("encode_bundle", dict(B=64, H=784, D=8192)),
    ("encode_bundle", dict(B=64, H=784, D=2048)),
    ("encode_bundle", dict(B=64, H=784, D=2040)),
    ("encode_bundle", dict(B=1024, H=784, D=8192)),
    ("encode_bundle_dynamic", dict(B=64, H=784, D=8192)),
    ("encode_bundle_dynamic", dict(B=64, H=784, D=2048)),
    ("encode_bundle_dynamic", dict(B=64, H=784, D=2040)),
    ("encode_bundle_dynamic", dict(B=1024, H=784, D=8192)),
    ("fit_bundle_int32", dict(B=512, H=784, D=8192, C=10)),
    ("hamming_topk", dict(B=64, C=10, W=256, k=1)),
    ("hamming_topk_tensor", dict(B=64, C=10, W=256, k=1)),
    *[("hamming_topk", dict(B=64, C=65548, W=256, k=k)) for k in (8, 33, 300, 1000)],
    ("hamming_topk", dict(B=64, C=1048576, W=256, k=8)),
    # small stores (ItemMemory's in the examples and launchers): the large-store path's
    # fixed cost a call
    *[("hamming_topk", dict(B=b, C=c, W=256, k=k)) for b in (1, 64) for c in (300, 5000)
      for k in (1, 8)],
    *[("hamming_packed", dict(B=64, C=c, W=w)) for c in (10, 65548) for w in (256, 64)],
    *[("hamming_packed_tensor", dict(B=64, C=10, W=w)) for w in (256, 64)],
    *[("bundle_binarize", dict(B=b, C=10, D=d)) for b, d in ((2048, 8192), (512, 8192), (256, 2048))],
]


def worker(src: Path, only: list[str]) -> int:
    """Time every case (or those `only` names) with the repro_torch under `src`;
    one JSON line each."""
    sys.path.insert(0, str(src))
    import torch

    from chip_smoke import device_ms
    from repro_torch.core import sobol
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    topk_path = ops.topk_path
    store_path = topk_path(ops.TOPK_WARP_MAX_ROWS + 1)
    packed_path = getattr(ops, "packed_path", None)

    def table(h, d, levels, dtype):
        t = sobol.sobol_table_for_features(h, d, levels, seed=0)
        return torch.from_numpy(t.astype(dtype)).to(dev)

    dirs = torch.from_numpy(sobol.quantized_direction_matrix(784, 16, seed=0)).to(dev)
    ok = True
    for name, shape in CASES:
        if only and not any(name.startswith(p) for p in only):
            continue
        i32 = dict(generator=gen, device=dev, dtype=torch.int32)
        if name == "encode_bundle":
            x = torch.randint(0, 17, (shape["B"], shape["H"]), **i32)
            tab = table(shape["H"], shape["D"], 16, "int8")
            fn, plain = (lambda: ops.encode_bundle(x, tab)), (lambda: [ref.encode_bundle(x, tab)])
        elif name == "encode_bundle_dynamic":
            x = torch.randint(0, 17, (shape["B"], shape["H"]), **i32)
            d = shape["D"]
            fn = lambda: ops.encode_bundle_dynamic(x, dirs, d)  # noqa: E731
            plain = lambda: [ref.encode_bundle_dynamic(x, dirs, d)]  # noqa: E731
        elif name == "fit_bundle_int32":  # the direct form: an int32 table (levels 256)
            x = torch.randint(0, 257, (shape["B"], shape["H"]), **i32)
            tab = table(shape["H"], shape["D"], 256, "int32")
            lab = torch.randint(0, shape["C"], (shape["B"],), **i32)
            fn = lambda: ops.fit_bundle(x, tab, lab, 10)  # noqa: E731
            plain = lambda: [ref.fit_bundle(x, tab, lab, 10)]  # noqa: E731
        elif name == "bundle_binarize":  # the baseline's training step: int32 sums
            hv = torch.randint(-784, 785, (shape["B"], shape["D"]), **i32)
            lab = torch.randint(0, shape["C"], (shape["B"],), **i32)
            fn = lambda: ops.bundle_binarize(hv, lab, 10, binarize=False)  # noqa: E731
            plain = lambda: [ref.bundle_binarize(  # noqa: E731
                hv, ref.class_onehot(lab, 10), binarize=False)]
        else:
            q = torch.randint(-2**31, 2**31 - 1, (shape["B"], shape["W"]), **i32)
            r = torch.randint(-2**31, 2**31 - 1, (shape["C"], shape["W"]), **i32)
            d = 32 * shape["W"]
            if name.startswith("hamming_packed"):
                fn = lambda: ops.hamming_packed(q, r, d)  # noqa: E731
                plain = lambda: [ref.hamming_packed(q, r, d)]  # noqa: E731
            else:
                k = shape["k"]
                fn = lambda: ops.hamming_topk(q, r, d, k)  # noqa: E731
                plain = lambda: ref.hamming_topk(q, r, d, k)  # noqa: E731
        # the wrappers read ops.topk_path and ops.packed_path at each call
        ops.topk_path = (lambda *_: store_path) if name == "hamming_topk_tensor" else topk_path
        if packed_path is not None:
            forced = name[len("hamming_packed_"):] if name.startswith("hamming_packed_") else None
            ops.packed_path = (lambda *_: forced) if forced else packed_path
        ops.reset_launches()
        got = fn()
        got = list(got) if isinstance(got, tuple) else [got]
        equal = all(torch.equal(g, w) for g, w in zip(got, plain()))
        ok &= equal
        keys = [k for v in ops.LAUNCH_SHAPES.values() for k in v]
        rows: list = []
        ms = device_ms(torch, fn, 20, rows)
        print(json.dumps({"case": name, "shape": shape, "equal": equal, "keys": keys,
                          "device_ms": ms, "rows": rows}), flush=True)
    return 0 if ok else 1


def main(argv: list[str]) -> int:
    only = argv[argv.index("--only") + 1].split(",") if "--only" in argv else []
    if "--worker" in argv:
        return worker(Path(argv[argv.index("--worker") + 1]), only)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; this script runs on a card", file=sys.stderr)
        return 1
    other = Path(argv[0]).resolve()
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    sides = {"other": other / "src", "this": ROOT / "src"}
    times: dict[str, dict[str, list[float]]] = {}
    failed = False
    for rnd in range(rounds):
        for side in ("other", "this", "this", "other"):
            out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                                  str(sides[side]), *(["--only", ",".join(only)] if only else [])],
                                 capture_output=True, text=True, cwd=ROOT)
            failed |= out.returncode != 0
            for line in out.stdout.splitlines():
                r = json.loads(line)
                key = f'{r["case"]} {" ".join(f"{k}={v}" for k, v in r["shape"].items())}'
                if isinstance(r["device_ms"], float):
                    times.setdefault(key, {"other": [], "this": []})[side].append(r["device_ms"])
                print(json.dumps({"side": side, "round": rnd, **r}), flush=True)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
    for key, t in times.items():
        ratio = (sum(t["this"]) / len(t["this"])) / (sum(t["other"]) / len(t["other"])) \
            if t["this"] and t["other"] else None
        print(json.dumps({"summary": key, "other_ms": t["other"], "this_ms": t["this"],
                          "this_over_other": ratio}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
