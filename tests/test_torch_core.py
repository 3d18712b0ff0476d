"""The port's core modules against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.
The datapath is integer arithmetic (and float32 only where the JAX
package computes in float32 exactly), so every comparison is **exact
equality** (no tolerance).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import encoding as jenc
from repro.core import hdc_model as jhm
from repro.core import metrics as jmetrics
from repro.core import sobol as jsobol
from repro.core import unary as junary
from repro.core.model import HDCConfig as JConfig
from repro_torch.core import encoding as tenc
from repro_torch.core import hdc_model as thm
from repro_torch.core import metrics as tmetrics
from repro_torch.core import registry as treg
from repro_torch.core import sobol as tsobol
from repro_torch.core import unary as tunary
from repro_torch.core.model import HDCConfig, config_from_manifest, manifest_config
from repro_torch.data import load_dataset as tload
from repro_torch.serving import ServingEngine
from repro_torch.serving.execution import resolve_impl

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("n_dims,levels,seed", [(1, 2, 0), (49, 16, 0), (113, 256, 3), (20, 65536, 1)])
def test_sobol_direction_numbers_equal_jax(n_dims, levels, seed):
    np.testing.assert_array_equal(
        tsobol.direction_matrix(n_dims, seed), jsobol.direction_matrix(n_dims, seed)
    )
    got = tsobol.quantized_direction_matrix(n_dims, levels, seed=seed)
    want = jsobol.quantized_direction_matrix(n_dims, levels, seed=seed)
    assert got.dtype == want.dtype == tsobol.quantized_direction_dtype(levels)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 31, 32, 33, 300, 1000])
def test_packing_and_popcount_equal_jax(d):
    rng = np.random.default_rng(d)
    hv = rng.integers(-5, 6, (4, d)).astype(np.int32)
    want = np.asarray(junary.pack_hypervector(jnp.asarray(hv)))
    got = tunary.pack_hypervector(torch.from_numpy(hv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    bits = rng.random((3, d)) < 0.5
    np.testing.assert_array_equal(
        tunary.pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32),
        np.asarray(junary.pack_bits(jnp.asarray(bits))),
    )
    np.testing.assert_array_equal(tunary.unpack_bits(got, d).numpy(), hv >= 0)
    np.testing.assert_array_equal(
        tunary.unpack_hypervector(got, d).numpy(),
        np.asarray(junary.unpack_hypervector(jnp.asarray(want), d)),
    )
    np.testing.assert_array_equal(
        tunary.popcount(got).numpy(), np.asarray(junary.popcount(jnp.asarray(want)))
    )


def test_popcount_of_extreme_words():
    words = np.asarray([[0, -1, 1, -(2**31), 2**31 - 1, 0x55555555]], np.int32)
    assert tunary.popcount(torch.from_numpy(words)).tolist() == [0 + 32 + 1 + 1 + 31 + 16]


@pytest.mark.parametrize("levels", [2, 16, 64, 256])
def test_quantize_images_all_intensities_equal_jax(levels):
    """Held against ``jax.jit`` of the JAX function: every model path of
    the JAX package quantizes inside jit, where XLA multiplies by
    float32(1/255) instead of dividing (the eager function divides)."""
    jq = jax.jit(jenc.quantize_images, static_argnums=1)
    x = np.arange(256, dtype=np.float32)[None, :]
    want = np.asarray(jq(jnp.asarray(x), levels))
    got = tenc.quantize_images(torch.from_numpy(x), levels)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # integer intensities agree with the eager (dividing) function too
    np.testing.assert_array_equal(got.numpy(), np.asarray(jenc.quantize_images(jnp.asarray(x), levels)))
    # non-integer intensities: 2**20 random floats, out-of-range ones included
    rng = np.random.default_rng(levels)
    x = rng.uniform(-5, 260, (1024, 1024)).astype(np.float32)
    np.testing.assert_array_equal(
        tenc.quantize_images(torch.from_numpy(x), levels).numpy(), np.asarray(jq(jnp.asarray(x), levels))
    )
    # out-of-range intensities clip like the JAX package's
    edge = np.asarray([[-3.0, 255.5, 1e9]], np.float32)
    np.testing.assert_array_equal(
        tenc.quantize_images(torch.from_numpy(edge), levels).numpy(),
        np.asarray(jq(jnp.asarray(edge), levels)),
    )
    # the known boundary pixel: synth_mnist (n_train=4096) image 533, pixel 471
    v = tload("synth_mnist", n_train=4096, n_test=1).train_images[533, 471]
    assert v == np.float32(239.06248)
    px = np.asarray([[v]], np.float32)
    got = int(tenc.quantize_images(torch.from_numpy(px), levels)[0, 0])
    assert got == int(jq(jnp.asarray(px), levels)[0, 0])
    if levels == 16:
        assert got == 15  # the jitted JAX paths' level
        assert int(jenc.quantize_images(jnp.asarray(px), levels)[0, 0]) == 14  # eager JAX divides


def test_bundle_by_class_and_label_validation_equal_jax():
    rng = np.random.default_rng(5)
    hv = rng.integers(-784, 785, (50, 70)).astype(np.int32)
    labels = rng.integers(-1, 5, 50).astype(np.int32)  # -1: dropped in both
    np.testing.assert_array_equal(
        tenc.bundle_by_class(torch.from_numpy(hv), torch.from_numpy(labels), 4).numpy(),
        np.asarray(jenc.bundle_by_class(jnp.asarray(hv), jnp.asarray(labels), 4)),
    )
    with pytest.raises(ValueError, match=r"labels must be in \[0, 4\)"):
        tenc.validate_labels(torch.from_numpy(labels), 4)
    tenc.validate_labels(np.asarray([0, 3]), 4)
    np.testing.assert_array_equal(
        tenc.binarize(torch.from_numpy(hv)).numpy(), np.asarray(jenc.binarize(jnp.asarray(hv)))
    )


def test_metrics_equal_jax():
    rng = np.random.default_rng(2)
    sim = rng.integers(0, 3, (20, 6)).astype(np.float32)  # many ties: first index wins
    np.testing.assert_array_equal(
        tmetrics.classify(torch.from_numpy(sim)).numpy(),
        np.asarray(jmetrics.classify(jnp.asarray(sim))),
    )
    q = tunary.pack_bits(torch.from_numpy(rng.random((5, 77)) < 0.5))
    c = tunary.pack_bits(torch.from_numpy(rng.random((3, 77)) < 0.5))
    np.testing.assert_array_equal(
        tmetrics.hamming_similarity_packed(q, c, 77).numpy(),
        np.asarray(jmetrics.hamming_similarity_packed(
            jnp.asarray(q.numpy().view(np.uint32)), jnp.asarray(c.numpy().view(np.uint32)), 77
        )),
    )


@pytest.mark.parametrize("d", [33, 1000])
def test_row_centering_equals_jax_where_its_sum_is_exact(d):
    """Row sums below 2**24: the port's int64 mean equals JAX's float32 mean."""
    rng = np.random.default_rng(d)
    hv = rng.integers(-3000, 3001, (6, d)).astype(np.int32)
    hv[0] = 7  # a row at its own mean: centred to exactly 0 -> bit 1
    jcfg = JConfig(n_features=4, n_classes=2, d=d, encoder="uhd_dynamic")
    tcfg = HDCConfig(n_features=4, n_classes=2, d=d, encoder="uhd_dynamic")
    want = np.asarray(jhm._centered(jcfg, jnp.asarray(hv)))
    got = thm._centered(tcfg, torch.from_numpy(hv))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start,step", [(2**31 - 3, 5), (2**32 - 1, 1), (2**32 + 7, 2**31)])
def test_n_seen_counter_across_int32_and_uint32_boundaries(start, step):
    want = jhm._nseen_array(start)
    np.testing.assert_array_equal(thm.nseen_array(start), np.asarray(want))
    want = jhm._nseen_add(want, step)
    np.testing.assert_array_equal(thm.nseen_array(start + step), np.asarray(want))
    assert thm.nseen_int(np.asarray(want)) == jhm._nseen_int(want) == start + step
    assert thm.nseen_int(np.asarray(want).view(np.int32)) == start + step
    with pytest.raises(ValueError):
        thm.nseen_array(2**64)


def test_config_validation_and_manifest_backend_names():
    with pytest.raises(ValueError, match="power of two"):
        HDCConfig(n_features=4, n_classes=2, levels=12, encoder="uhd_dynamic")
    with pytest.raises(ValueError, match="unknown encoder"):
        HDCConfig(n_features=4, n_classes=2, encoder="no_such_encoder")
    HDCConfig(n_features=4, n_classes=2, encoder="baseline")  # ported: constructs
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        HDCConfig(n_features=4, n_classes=2, encoder="uhd_dynamic", backend="pallas")
    cfg = HDCConfig(n_features=4, n_classes=2, encoder="uhd_dynamic", backend="cuda")
    raw = manifest_config(cfg)
    assert raw["backend"] == "pallas"  # never "cuda" in a manifest
    JConfig(**raw)  # the JAX package accepts what the port writes
    # the backend is chosen where the model runs: any stored name reads as "auto"
    assert config_from_manifest(raw) == dataclasses.replace(cfg, backend="auto")
    raw_j = dict(raw, backend="ref", use_kernels=None, encode_impl=None)
    assert config_from_manifest(raw_j).backend == "auto"


def test_default_config_constructs_as_in_jax():
    """``HDCConfig`` with default arguments names the ``uhd`` encoder in
    both packages, and the port registers it."""
    cfg, jcfg = HDCConfig(n_features=4, n_classes=2), JConfig(n_features=4, n_classes=2)
    assert cfg.encoder == jcfg.encoder == "uhd"
    raw = manifest_config(cfg)
    assert {k: v for k, v in dataclasses.asdict(jcfg).items() if k in raw} == raw
    assert treg.get_encoder("uhd").family == treg.get_encoder("uhd_dynamic").family == "uhd"


def test_backend_and_impl_follow_the_device():
    assert treg.resolve_backend("auto", "cpu", encoder="uhd_dynamic") == "ref"
    assert treg.resolve_backend("auto", "cuda", encoder="uhd_dynamic") == "cuda"
    with pytest.raises(ValueError, match="does not run on 'cuda'"):
        treg.resolve_backend("ref", "cuda", encoder="uhd_dynamic")
    with pytest.raises(ValueError, match="does not run on 'cpu'"):
        treg.resolve_backend("cuda", "cpu", encoder="uhd_dynamic")
    assert resolve_impl("auto", "cpu") == "ref"
    assert resolve_impl("auto", "cuda") == "cuda"
    for impl, platform in (("ref", "cuda"), ("cuda", "cpu"), ("jnp", "cpu")):
        with pytest.raises(ValueError):
            resolve_impl(impl, platform)


def test_entry_points_default_to_the_card_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HDCConfig(n_features=49, n_classes=3, d=64, encoder="uhd_dynamic")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thm.HDCModel.create(cfg)
    model = thm.HDCModel.create(cfg, device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    assert ServingEngine(model, device="cpu").impl == "ref"


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of repro_torch, found by walking the package, imports
    neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert {'repro_torch.launch.serve', 'repro_torch.models.transformer',\n"
        "        'repro_torch.configs.qwen3_0_6b', 'repro_torch.obs.aggregator',\n"
        "        'repro_torch.launch.train', 'repro_torch.training.step', 'repro_torch.optim.adamw',\n"
        "        'repro_torch.data.tokens', 'repro_torch.distributed.compress',\n"
        "        'repro_torch.launch.dryrun', 'repro_torch.launch.specs',\n"
        "        'repro_torch.analysis.roofline', 'repro_torch.examples.quickstart'} <= set(mods), mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
