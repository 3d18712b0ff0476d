"""The plain reference against the program, on the CPU at small sizes:
quantization, the encode of both encoders, class sums, the packing
policy, labels and the pinned top-k."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from bench.images import StrokeImages
from bench.reference import hdc as ref_hdc
from bench.reference import sobol
from repro_torch.core import encoding
from repro_torch.core import sobol as port_sobol
from repro_torch.core.hdc_model import HDCModel, predict_packed
from repro_torch.core.item_memory import ItemMemory
from repro_torch.core.model import HDCConfig

ENCODERS = ("uhd", "uhd_dynamic")


def _hdc(encoder: str, d: int = 256, **over) -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" / f"{encoder}-mnist-d8192.json").read_text())
    return {**cfg["hdc"], "d": d, **over}


def _images(n: int, seed: int = 3):
    spec = json.loads((ROOT / "bench" / "configs" / "uhd-mnist-d8192.json").read_text())["images"]
    return StrokeImages(spec, seed, "cpu").draw(n)


def test_frozen_polynomials_are_the_search():
    assert sobol.frozen_polynomials() == sobol.search_primitive(13)


@pytest.mark.parametrize("n, d, levels, seed, skip",
                         [(784, 512, 16, 0, 1), (40, 300, 8, 3, 5), (784, 64, 256, 1, 1)])
def test_threshold_table_matches_the_port(n, d, levels, seed, skip):
    ours = sobol.threshold_table(n, d, levels, seed=seed, skip=skip).numpy()
    theirs = port_sobol.sobol_table_for_features(n, d, levels, seed=seed, skip=skip)
    np.testing.assert_array_equal(ours, theirs)


def test_quantize_matches_the_port_near_level_edges():
    edges = np.arange(0, 256, 255 / 16, dtype=np.float32)
    x = np.concatenate([edges, np.nextafter(edges, 0), np.nextafter(edges, 300),
                        np.random.default_rng(0).uniform(-5, 260, 2000).astype(np.float32)])
    x = torch.from_numpy(x)[None]
    np.testing.assert_array_equal(ref_hdc.quantize(x, 16, 255.0).numpy(),
                                  encoding.quantize_images(x, 16, 255.0).numpy())


@pytest.mark.parametrize("encoder", ENCODERS)
def test_encode_and_class_sums_match_the_port(encoder):
    hdc = _hdc(encoder)
    x, y = _images(200)
    model = HDCModel.create(HDCConfig(**hdc), device="cpu")
    ref = ref_hdc.Reference(hdc)
    np.testing.assert_array_equal(ref.encode(x).numpy(), model.encode(x).numpy())
    fitted = model.fit(x, y)
    np.testing.assert_array_equal(ref.class_sums(x, y, block=64).numpy(),
                                  fitted.class_sums.numpy())


@pytest.mark.parametrize("encoder", ENCODERS)
def test_packing_and_labels_match_the_port(encoder):
    hdc = _hdc(encoder)
    x, y = _images(300, seed=4)
    model = HDCModel.create(HDCConfig(**hdc), device="cpu").fit(x[:200], y[:200])
    ref = ref_hdc.Reference(hdc)
    hv = model.encode(x[200:])
    np.testing.assert_array_equal(ref_hdc.pack_bits(ref.centred_bits(hv)).numpy(),
                                  model.pack_queries(hv).numpy())
    sums = ref.class_sums(x[:200], y[:200])
    np.testing.assert_array_equal(ref.labels(x[200:], sums).numpy(),
                                  predict_packed(model, x[200:], model.pack()).numpy())


def test_unpack_inverts_pack():
    bits = torch.rand((5, 70), generator=torch.Generator().manual_seed(1)) < 0.5
    np.testing.assert_array_equal(ref_hdc.unpack_words(ref_hdc.pack_bits(bits), 70), bits)


def test_topk_matches_the_store_with_ties():
    g = torch.Generator().manual_seed(2)
    d = 96
    rows = torch.rand((300, d), generator=g) < 0.5
    rows[150:200] = rows[100:150]  # duplicates: equal distances, pinned by row
    queries = torch.cat([rows[[3, 120, 160]], torch.rand((5, d), generator=g) < 0.5])
    words = ref_hdc.pack_bits(rows)
    store = ItemMemory(d, device="cpu")
    store.add_packed(words)
    idx, dist = store.search(ref_hdc.pack_bits(queries).view(torch.uint32), 7)
    r_idx, r_dist = ref_hdc.topk_pinned(queries, words, d, 7, "cpu", block=64)
    np.testing.assert_array_equal(r_idx.numpy(), idx)
    np.testing.assert_array_equal(r_dist.numpy(), dist)


@pytest.mark.parametrize("block", [7, 8192])
def test_encode_is_the_compare_count(block):
    """The product form of the encode against its definition, images at
    every level edge included."""
    hdc = _hdc("uhd", d=96)
    ref = ref_hdc.Reference(hdc)
    x, _ = _images(40)
    x[0] = 255.0
    x[1] = 0.0
    x[2] = torch.arange(784) % 256
    q = ref.quantize(x)
    direct = 2 * (q[:, :, None] >= ref.table[None]).sum(1, dtype=torch.int32) - ref.h
    np.testing.assert_array_equal(ref.encode(x, block=block).numpy(), direct.numpy())
