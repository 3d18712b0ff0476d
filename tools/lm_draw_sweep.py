"""Sweep of JAX's weight draws for the float32 LM parity tests.

JAX's ``init_params`` salts each leaf's key with Python's ``hash()`` of its
path, so each ``PYTHONHASHSEED`` gives other smoke weights.  For each hash
seed this runs, in a subprocess of its own (one thread unless
``--threads`` says otherwise), the cases of
``tests/test_torch_lm_stack.py`` (every arch: full forward, prefill, 4
decode steps) and the JAX-drawn cases of ``tests/test_torch_lm_models.py``
(the blocked prefill of gemma3-12b and llama-3.2-vision-90b, gemma3-12b's
rolling window from prompts 5 and 12) on that draw, and records for each
output the port's largest distance from JAX and JAX's own largest move
when every weight is scaled by (1 + 1e-6 eps), eps from numpy's seed 0
(``torch_lm_parity.moved``).  The ratio of the two says whether the port
parts from JAX by more than the function's float32 conditioning does.

    python tools/lm_draw_sweep.py --seeds 0-63 --jobs 6 --out sweep.jsonl
    python tools/lm_draw_sweep.py --seeds 0-63 --cases xlstm --threads 0

(``--threads 0`` keeps torch's and XLA's default thread counts, as pytest
runs them; the rounding, and so the distance, depends on the count)

prints one row per case: draws, the largest distance, the smallest and
largest move, the largest ratio, the draws that fail the test's fixed
tolerance, and the worst hash seeds by ratio.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
              "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false"}


def _cases():
    """(name, arch, overrides, batch length, batch seed, prompt, decode steps, atol)."""
    from repro.configs import ARCHS

    out = [(f"stack/{a}", a, {}, 16, 1, 12, 4, 1e-3 if a == "xlstm-1.3b" else 1e-4) for a in ARCHS]
    blocked = dict(attn_block_threshold=16, attn_block_q=8, attn_block_kv=8)
    out += [(f"blocked/{a}", a, blocked, 34, 2, 32, 2, 1e-4) for a in ("gemma3-12b", "llama-3.2-vision-90b")]
    out += [(f"rolling{p}/gemma3-12b", "gemma3-12b", {}, p + 10, 3, p, 10, 1e-4) for p in (5, 12)]
    return out


def worker(cases: str, threads: int) -> None:
    """One hash seed (this process's): a JSON line per case whose name
    holds one of the comma-separated `cases` (all if empty)."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import numpy as np
    import torch

    if threads:
        torch.set_num_threads(threads)
    from repro.configs import get_smoke_config as jget
    from repro_torch.configs import get_smoke_config as tget
    from torch_lm_parity import as_f32, batch_for, jax_params, port_run, witness_moves

    for name, arch, over, n, seed, s, n_dec, atol in _cases():
        if cases and not any(c in name for c in cases.split(",")):
            continue
        jc = dataclasses.replace(as_f32(jget(arch)), **over)
        tc = dataclasses.replace(as_f32(tget(arch)), **over)
        batch = batch_for(jc, 2, n, seed=seed)
        jout, moves = witness_moves(jc, jax_params(arch), batch, s, n_dec)
        tout = port_run(tc, jax_params(arch), batch, s, n_dec)
        dist = [float(np.abs(t - j).max()) for t, j in zip(tout, jout)]
        ok = all(np.allclose(t, j, rtol=1e-4, atol=atol) for t, j in zip(tout, jout))
        own = [float(np.abs(tout[1 + i] - tout[0][:, s - 1 + i]).max()) for i in range(n_dec + 1)]
        print(json.dumps({"case": name, "hashseed": int(os.environ["PYTHONHASHSEED"]), "dist": dist,
                          "move": moves, "fixed_tol_ok": bool(ok), "own_decode": max(own)}), flush=True)


def _run_seed(seed: int, cases: str, threads: int) -> list[dict]:
    env = dict(os.environ, PYTHONHASHSEED=str(seed), JAX_PLATFORMS="cpu",
               **(ONE_THREAD if threads == 1 else {}))
    res = subprocess.run([sys.executable, __file__, "--worker", "--cases", cases,
                          "--threads", str(threads)], capture_output=True, text=True,
                         env=env, timeout=3600)
    if res.returncode:
        raise RuntimeError(f"hash seed {seed}: {res.stderr[-3000:]}")
    return [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]


def table(recs: list[dict]) -> str:
    rows = ["| case | draws | largest distance | JAX's move (least, largest) | largest ratio "
            "| fixed-tolerance misses | worst hash seeds (ratio) |",
            "|---|---|---|---|---|---|---|"]
    for case in dict.fromkeys(r["case"] for r in recs):
        rs = [r for r in recs if r["case"] == case]
        ratio = {r["hashseed"]: max(d / m for d, m in zip(r["dist"], r["move"])) for r in rs}
        worst = sorted(ratio, key=ratio.get, reverse=True)[:4]
        misses = sorted(r["hashseed"] for r in rs if not r["fixed_tol_ok"])
        rows.append(f"| {case} | {len(rs)} | {max(max(r['dist']) for r in rs):.3g} "
                    f"| {min(max(r['move']) for r in rs):.3g}, {max(max(r['move']) for r in rs):.3g} "
                    f"| {max(ratio.values()):.3g} | {len(misses)} {misses if misses else ''} "
                    f"| {', '.join(f'{s} ({ratio[s]:.2f})' for s in worst)} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--seeds", default="0-63", help="hash seeds, 'a-b' inclusive or a comma list")
    ap.add_argument("--jobs", type=int, default=4, help="subprocesses at once")
    ap.add_argument("--cases", default="", help="comma-separated parts of case names (default all)")
    ap.add_argument("--threads", type=int, default=1,
                    help="threads of each subprocess; 0 leaves torch's and XLA's defaults")
    ap.add_argument("--out", type=Path, help="write every record here as JSON lines")
    args = ap.parse_args()
    if args.worker:
        return worker(args.cases, args.threads)
    if "-" in args.seeds:
        lo, hi = map(int, args.seeds.split("-"))
        seeds = list(range(lo, hi + 1))
    else:
        seeds = [int(s) for s in args.seeds.split(",")]
    recs: list[dict] = []
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        for got in pool.map(lambda sd: _run_seed(sd, args.cases, args.threads), seeds):
            recs += got
    if args.out:
        args.out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    print(table(recs))


if __name__ == "__main__":
    main()
