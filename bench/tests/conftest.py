"""Shared fixtures of the benchmark's CPU tests: the repository root on the
path, and a copy of the benchmark cut to sizes a CPU test can hold.

Run from the repository root: ``python -m pytest -q bench/tests``.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the traffic parameters of the small copy: the same entries and shapes
#: of work, fewer images
SMALL_TRAFFIC = {
    "classify": dict(block=32, pool_images=96, fit_images=256, fit_block=64),
    "search_1m": dict(block=16, pool_images=64, store_rows=700),
}
SMALL_D = 256


def small_copy(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/`` under `dest`, the configurations at
    D = 256 and the traffic cut to :data:`SMALL_TRAFFIC`."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dest / "bench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["hdc"]["d"] = SMALL_D
        f.write_text(json.dumps(cfg))
    for name, over in SMALL_TRAFFIC.items():
        f = dest / "bench" / "traffic" / f"{name}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **over}))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    return small_copy(tmp_path_factory.mktemp("bench_small"))


@pytest.fixture(scope="session")
def workloads() -> list[str]:
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    """The first CUDA card; skips without one (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
