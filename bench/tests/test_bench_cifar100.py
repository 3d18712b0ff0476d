"""The CIFAR-100-shaped cell on the CPU at small sizes: the reference past
1,110 features (its frozen polynomials, its thresholds against the
program's), the colour images (shape, channel order, seed determinism),
and whole runs of the cell, correct, with its faults and its control not
correct, and its set-up's spans."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
from conftest import ROOT, small_copy

from bench import cells, entries
from bench.control import control_checks
from bench.entries.classify_rgb import ColourStrokeImages
from bench.harness import run_cell
from bench.reference import sobol, wide
from bench.setup_spans import setup_split
from repro_torch.core import sobol as port_sobol

CELL = "uhd_dynamic-cifar100-d8192.classify_rgb"
CONFIG = json.loads((ROOT / "bench" / "configs" / "uhd_dynamic-cifar100-d8192.json").read_text())
SPEC = CONFIG["images"]
CPU = torch.device("cpu")


def test_frozen_polynomials_to_degree_15_are_the_search():
    polys = wide.frozen_polynomials()
    assert polys == sobol.search_primitive(15)
    assert len(polys) == 3666 and polys[-1].bit_length() - 1 == 15


def test_their_first_1110_are_the_degree_13_file():
    assert wide.frozen_polynomials()[:1110] == sobol.frozen_polynomials()


@pytest.mark.parametrize("n, d, levels, seed, skip", [(3072, 64, 16, 0, 1), (1200, 40, 8, 2, 5)])
def test_thresholds_past_1110_features_match_the_port(n, d, levels, seed, skip):
    ours = wide.threshold_table(n, d, levels, seed=seed, skip=skip).numpy()
    np.testing.assert_array_equal(
        ours, port_sobol.sobol_table_for_features(n, d, levels, seed=seed, skip=skip))
    np.testing.assert_array_equal(ours[:1111], sobol.threshold_table(
        min(n, 1111), d, levels, seed=seed, skip=skip).numpy())


def test_colour_images_shape_range_and_labels():
    x, y = ColourStrokeImages(SPEC, 7, "cpu").draw(600)
    assert x.shape == (600, 3072) and x.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 255.0
    assert y.dtype == torch.int32 and int(y.min()) >= 0 and int(y.max()) < 100
    assert len(set(y.tolist())) > 90


def test_colour_images_are_channel_major():
    """Without noise each channel's plane is the one grey plane times the
    class's weight for that channel."""
    quiet = {**SPEC, "noise_std": 0.0, "channel_noise_std": 0.0}
    gen = ColourStrokeImages(quiet, 3, "cpu")
    x, y = gen.draw(50)
    planes = x.view(50, 3, 1024)
    tint = gen.tint[y.long()]
    for k in (1, 2):
        torch.testing.assert_close(planes[:, k] * tint[:, :1], planes[:, 0] * tint[:, k:k + 1],
                                   rtol=1e-5, atol=1e-3)
    assert not torch.equal(planes[:, 0], planes[:, 1])


def test_colour_images_same_seed_same_images_large_seed():
    seed = 2**31 + 987_654_321
    a = ColourStrokeImages(SPEC, seed, "cpu").draw(32)
    b = ColourStrokeImages(SPEC, seed, "cpu").draw(32)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], ColourStrokeImages(SPEC, seed + 1, "cpu").draw(32)[0])


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small copy of the benchmark with this cell's traffic cut too."""
    root = small_copy(tmp_path_factory.mktemp("bench_cifar"))
    f = root / "bench" / "traffic" / "classify_rgb.json"
    f.write_text(json.dumps({**json.loads(f.read_text()),
                             **dict(block=32, pool_images=96, fit_images=256, fit_block=64)}))
    return cells.load_cell(root, CELL)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_is_correct(small, trace):
    out = run_cell(small, 2**31 + 12_345, 0.3, trace, CPU, time.monotonic())
    assert out["correct"], (out["checks"], out["errors"])
    assert out["checks"]["labels_compared"] >= 32 and out["images"] > 0


def test_an_altered_label_is_not_correct(small, monkeypatch):
    from repro_torch.serving.engine import ServingEngine

    orig = ServingEngine.predict

    def predict(self, images):
        labels = orig(self, images).copy()
        labels[-1] = (labels[-1] + 1) % self.model.cfg.n_classes
        return labels
    monkeypatch.setattr(ServingEngine, "predict", predict)
    out = run_cell(small, 4, 0.3, False, CPU, time.monotonic())
    assert not out["correct"] and out["checks"]["label_mismatches"] > 0


def test_the_control_is_not_correct(small):
    checks = control_checks(small, 5, CPU)
    assert not entries.passed(checks), checks


def test_traffic_that_does_not_fit_the_configuration_is_refused(small):
    for over in ({"channels": 1}, {"side": 28}, {"k": 2}):
        cell = cells.Cell(small.root, small.name, 1, small.config, {**small.traffic, **over})
        with pytest.raises(ValueError):
            cell.entry_class()(cell, 1, CPU).setup()


def test_the_setup_split_holds_the_setup_spans(small):
    out = setup_split(small, 6, CPU)
    assert out["spans"]["sobol.directions"]["n"] == 1
    assert out["spans"]["model.fit"]["n"] == 256 // 64
    assert out["spans_dropped"] == 0 and 0 <= out["outside_ms"] <= out["setup_ms"]
