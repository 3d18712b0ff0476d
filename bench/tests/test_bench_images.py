"""The device-seeded stroke images: deterministic in the seed, with the
shapes, range and labels of the configuration."""

from __future__ import annotations

import json

import torch
from conftest import ROOT

from bench.images import StrokeImages

SPEC = json.loads((ROOT / "bench" / "configs" / "uhd-mnist-d8192.json").read_text())["images"]


def test_same_seed_same_images_large_seed():
    seed = 2**31 + 987_654_321
    a = StrokeImages(SPEC, seed, "cpu").draw(64)
    b = StrokeImages(SPEC, seed, "cpu").draw(64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_other_seed_other_images():
    a, _ = StrokeImages(SPEC, 1, "cpu").draw(16)
    b, _ = StrokeImages(SPEC, 2, "cpu").draw(16)
    assert not torch.equal(a, b)


def test_shape_range_labels_and_strokes():
    x, y = StrokeImages(SPEC, 5, "cpu").draw(500)
    assert x.shape == (500, 784) and x.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 255.0
    assert y.dtype == torch.int32 and set(y.tolist()) == set(range(10))
    # bright strokes on a dark, noisy background, as synth_mnist
    assert float((x > 150).float().mean()) > 0.02
    assert float(x.median()) < 40.0


def test_chunks_are_deterministic():
    a = torch.cat([x for x, _ in StrokeImages(SPEC, 9, "cpu").draw_chunks(100, 32)])
    b = torch.cat([x for x, _ in StrokeImages(SPEC, 9, "cpu").draw_chunks(100, 32)])
    assert a.shape == (100, 784) and torch.equal(a, b)
