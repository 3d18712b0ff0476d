"""The harness on the CPU at small sizes: cells found from data alone,
every cell's run judged correct, each fault a cell can have judged not
correct, the control judged not correct, and no result without a card or
without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import ROOT, small_copy

from bench import cells, entries
from bench.control import control_checks
from bench.harness import run_cell

CPU = torch.device("cpu")


def _run(root, workload, trace=False, seconds=0.3):
    return run_cell(cells.load_cell(root, workload), 11, seconds, trace, CPU, time.monotonic())


def test_an_added_configuration_cell_and_metric_are_found(tmp_path):
    """A configuration, a kind of traffic with its mix, a cell, an
    end-to-end and a per-layer metric added as files and entries alone."""
    root = small_copy(tmp_path)
    cfg = json.loads((root / "bench/configs/uhd-mnist-d8192.json").read_text())
    cfg["hdc"]["d"] = 128
    (root / "bench/configs/uhd-mnist-d128.json").write_text(json.dumps(cfg))
    (root / "bench/entries/classify_twice.py").write_text(
        "from bench.entries import classify\n\n\n"
        "class Twice(classify.Classify):\n"
        "    def step(self, blk, spans):\n"
        "        super().step(blk, spans)\n"
        "        return super().step(blk, spans)\n\n\n"
        "ENTRY = Twice\n")
    (root / "bench/traffic/classify_tiny.json").write_text(json.dumps(
        {"entry": "classify_twice", "block": 16, "pool_images": 32, "fit_images": 64,
         "fit_block": 32}))
    (root / "bench/metrics/steps_traced.py").write_text("def read(run):\n"
                                                        "    return run['summary'].steps\n")
    (root / "bench/metrics/blocks_per_s.py").write_text(
        "def read(run):\n    return run['images'] / 16 / run['window_s']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "uhd-mnist-d128", "source": "test",
                            "file": "bench/configs/uhd-mnist-d128.json", "reduced": ["d"],
                            "why": "test"})
    spec["workloads"].append({"name": "uhd-mnist-d128.classify_tiny", "config": "uhd-mnist-d128",
                              "traffic": "classify_tiny", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "blocks_per_s", "unit": "blocks/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["uhd-mnist-d128.classify_tiny"]})
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "model step",
                              "moves": "blocks_per_s", "workloads": ["uhd-mnist-d128.classify_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load_cell(root, "uhd-mnist-d128.classify_tiny")
    assert cell.config["hdc"]["d"] == 128 and cell.traffic["block"] == 16
    assert cell.entry_class().__name__ == "Twice"
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    e2e = [m["name"] for m in cell.end_to_end]
    assert "blocks_per_s" in e2e and "images_per_s" not in e2e  # its list names cells
    out = run_cell(cell, 3, 0.3, True, CPU, time.monotonic())
    assert out["correct"] and cells.metric_reader(root, "steps_traced")(out) >= 0
    assert cells.metric_reader(root, "blocks_per_s")(out) > 0


@pytest.mark.parametrize("trace", [False, True])
def test_every_cell_is_correct(small_root, workloads, trace):
    for w in workloads:
        out = _run(small_root, w, trace)
        assert out["correct"], (w, out["checks"], out["errors"])
        assert out["attempted"] >= 1 and out["failed"] == 0 and out["images"] > 0


def _alter_label(monkeypatch):
    from repro_torch.serving.engine import ServingEngine

    orig = ServingEngine.predict

    def predict(self, images):
        labels = orig(self, images).copy()
        labels[0] = (labels[0] + 1) % self.model.cfg.n_classes
        return labels
    monkeypatch.setattr(ServingEngine, "predict", predict)


def _alter_row(monkeypatch):
    from repro_torch.core.item_memory import ItemMemory

    orig = ItemMemory.search

    def search(self, queries, k):
        idx, dist = orig(self, queries, k)
        idx = idx.copy()
        idx[0, 0] = (idx[0, 0] + 1) % len(self)
        return idx, dist
    monkeypatch.setattr(ItemMemory, "search", search)


def _state_unchanged(monkeypatch):
    from repro_torch.core.hdc_model import HDCModel

    monkeypatch.setattr(HDCModel, "partial_fit", lambda self, images, labels, donate=False: self)


def _half_batch(monkeypatch):
    """Half of each block left out, its sums scaled up to the whole block."""
    from repro_torch.core.hdc_model import HDCModel

    orig = HDCModel.partial_fit

    def partial_fit(self, images, labels, donate=False):
        half = len(labels) // 2
        before = self.class_sums.clone()
        model = orig(self, images[:half], labels[:half], donate=donate)
        model.class_sums += model.class_sums - before
        return model
    monkeypatch.setattr(HDCModel, "partial_fit", partial_fit)


@pytest.mark.parametrize("workload, fault", [
    ("uhd_dynamic-mnist-d8192.classify", _alter_label),
    ("uhd-mnist-d8192.search_1m", _alter_row),
    ("uhd_dynamic-mnist-d8192.classify", _state_unchanged),
    ("uhd_dynamic-mnist-d8192.classify", _half_batch),
])
def test_a_fault_is_not_correct(small_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = _run(small_root, workload)
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct(small_root, workloads):
    for w in workloads:
        checks = control_checks(cells.load_cell(small_root, w), 5, CPU)
        assert not entries.passed(checks), (w, checks)


def test_nothing_compared_is_not_correct():
    assert not entries.passed({"label_mismatches": 0, "labels_compared": 0})
    assert entries.passed({"label_mismatches": 0, "labels_compared": 5})


def _bench_run(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "uhd_dynamic-mnist-d8192.classify", "--seed", "1", "--seconds", "1", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _bench_run(ROOT)
    assert res.returncode == 2 and res.stdout == "" and "CUDA card" in res.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _bench_run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    res = _bench_run(ROOT, "--trace", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert all(np.isfinite(m["value"]) for m in line["metrics"].values())
    assert list(line)[-1] == "checks"
