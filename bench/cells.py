"""Find a cell's configuration, traffic mix and metrics by their names.

``BENCHMARK.json`` names each cell's configuration (whose entry names its
file under ``bench/configs/``) and its traffic mix
(``bench/traffic/<traffic>.json``, which names its kind,
``bench/entries/<entry>.py``); every metric ``<name>``, end-to-end or
per-layer, is read by ``bench/metrics/<name>.py`` from the run's record.
A later change adds a cell, a kind or a metric by adding such files and
entries; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)

    @property
    def entry(self) -> str:
        return self.traffic["entry"]

    def entry_class(self):
        """The ``ENTRY`` class of ``bench/entries/<entry>.py``."""
        return _module(self.root, "entries", self.entry).ENTRY


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of ``<root>/BENCHMARK.json`` with its files read."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        root=root, name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)],
    )


def _module(root: Path, folder: str, name: str):
    """``<root>/bench/<folder>/<name>.py``, loaded from its file."""
    path = Path(root) / "bench" / folder / f"{name}.py"
    tag = f"bench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str):
    """The ``read(run)`` function of ``bench/metrics/<name>.py``: it takes
    the run's record (``bench.harness.run_cell``) and returns the metric,
    or None where the run holds nothing for it to read."""
    return _module(root, "metrics", name).read
