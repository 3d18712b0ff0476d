"""The port's baseline encoder, its kernels 7 and 8, and the JAX
package's other uHD datapaths, against the JAX package.

Inputs are made with numpy from a seed (or by the byte-identical
synthetic datasets) and handed to both packages; the JAX side runs on
the CPU, its Pallas ops in interpret mode as its own tests run them.
The baseline codebooks come from ``jax.random`` in JAX and from the
port's numpy copy of its generator (``core/prng.py``); every datapath
compared here is integer arithmetic or sign bits, so every comparison
is **exact equality** (tolerance 0).  The one float32 path, cosine
``predict``, is held to the class sums exactly and to its labels up to
float32 near-ties (at most 2 of the test images differ, each where
JAX's top-2 float32 margin is below 1e-6).  Tests marked ``cuda`` hold
kernels 7 and 8 against their plain versions on a card and skip
without one; they need no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch.core import HDCConfig, HDCModel, partial_fit_sharded, prng
from repro_torch.core import encoding as tenc
from repro_torch.core import hdc_model as thm
from repro_torch.core import registry as treg
from repro_torch.core import unary as tunary
from repro_torch.core.model import manifest_config
from repro_torch.data import load_dataset as tload
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve_hdc as tserve
from repro_torch.launch import train_hdc as ttrain
from repro_torch.launch.mesh import mesh_for

try:  # a machine with a card runs the cuda-marked tests alone, and may have no JAX
    import jax
    import jax.numpy as jnp

    from repro.core import HDCConfig as JConfig
    from repro.core import HDCModel as JModel
    from repro.core import encoding as jenc
    from repro.core import hdc_model as jhm
    from repro.core import metrics as jmetrics
    from repro.core import unary as junary
    from repro.core.registry import backend_names as jbackend_names
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ModuleNotFoundError:
    jax = None

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _jax_side(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs the JAX package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The generator and the codebooks
# ---------------------------------------------------------------------------


def test_jax_draws_in_the_partitionable_threefry_form():
    """The port copies JAX's ``jax_threefry_partitionable=True`` draws; a
    JAX whose default differs fails here, not as a value mismatch."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_prng_key_split_and_uniform_equal_jax_random(seed):
    assert jax.config.jax_threefry_partitionable is True
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.prng_key(seed), np.asarray(key))
    for num in (2, 3):
        np.testing.assert_array_equal(
            prng.split(prng.prng_key(seed), num), np.asarray(jax.random.split(key, num))
        )
    sub = np.asarray(jax.random.split(key)[1])
    for shape, lo, hi in [((37, 301), 0.0, 1.0), ((1001,), 0.0, 17.0), ((3, 5, 7), -2.0, 3.0)]:
        want = np.asarray(jax.random.uniform(jnp.asarray(sub), shape, minval=lo, maxval=hi))
        got = prng.uniform(sub, shape, lo, hi)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("h,d,levels", [(784, 1024, 16), (37, 300, 2), (5, 33, 255)])
def test_make_baseline_codebooks_equal_jax(h, d, levels):
    for seed in (0, 3):
        want_p, want_l = jenc.make_baseline_codebooks(jax.random.PRNGKey(seed), h, d, levels)
        p, level = tenc.make_baseline_codebooks(prng.prng_key(seed), h, d, levels)
        assert p.dtype == level.dtype == torch.int8
        np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(level.numpy(), np.asarray(want_l))


# ---------------------------------------------------------------------------
# Encodes: the baseline forms and the JAX package's other uHD datapaths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,d,levels", [(5, 37, 300, 16), (9, 113, 130, 2), (3, 784, 64, 16)])
def test_baseline_encode_forms_equal_jax(b, h, d, levels):
    rng = np.random.default_rng(b * h + d)
    x = rng.integers(0, levels + 1, (b, h)).astype(np.int32)
    jp, jl = jenc.make_baseline_codebooks(jax.random.PRNGKey(b), h, d, levels)
    want = np.asarray(jenc.baseline_encode(jnp.asarray(x), jp, jl))
    np.testing.assert_array_equal(np.asarray(jenc.baseline_encode_naive(jnp.asarray(x), jp, jl)), want)
    p, level = _t(np.asarray(jp)), _t(np.asarray(jl))
    np.testing.assert_array_equal(tenc.baseline_encode(_t(x), p, level).numpy(), want)
    np.testing.assert_array_equal(tenc.baseline_encode_naive(_t(x), p, level).numpy(), want)
    # kernel 7's identity: 2 * (onehot(x) @ [P == L]) - H, K padded to 32
    u, o, hh = tref.baseline_operands(_t(x), p, level)
    assert hh == h and u.shape[1] == o.shape[1] and u.shape[1] % 32 == 0
    assert u.shape[1] - (levels + 1) * h < 32 and (u.sum(1) == h).all()
    np.testing.assert_array_equal(tops.encode_unary_mxu_operands(u, o, hh).numpy(), want)


@pytest.mark.parametrize("b,h,d", [(4, 30, 200), (8, 112, 512), (3, 784, 256)])
def test_encode_unary_mxu_equals_jax(b, h, d):
    rng = np.random.default_rng(b + h + d)
    x = rng.integers(0, 17, (b, h)).astype(np.int32)
    s = rng.integers(0, 16, (h, d)).astype(np.int32)
    want = np.asarray(jops.encode_unary_mxu(jnp.asarray(x), jnp.asarray(s), 16))
    np.testing.assert_array_equal(np.asarray(jref.encode_bundle(jnp.asarray(x), jnp.asarray(s))), want)
    np.testing.assert_array_equal(tops.encode_unary_mxu(_t(x), _t(s), 16).numpy(), want)
    u, o, hh = tref.unary_mxu_operands(_t(x), _t(s), 16)
    np.testing.assert_array_equal(tref.encode_unary_mxu(u, o, hh).numpy(), want)
    # the JAX package's operand-level plain version, on the same operands
    jwant = jref.encode_unary_mxu(jnp.asarray(u.numpy()), jnp.asarray(o.numpy().T), hh)
    np.testing.assert_array_equal(np.asarray(jwant), want)


def test_encode_unary_mxu_operands_pad_an_unaligned_depth():
    rng = np.random.default_rng(5)
    u = _t(rng.integers(0, 2, (6, 45)).astype(np.int8))
    o = _t(rng.integers(0, 2, (11, 45)).astype(np.int8))
    want = 2 * (u.to(torch.int64) @ o.to(torch.int64).t()) - 7
    assert torch.equal(tops.encode_unary_mxu_operands(u, o, 7), want.to(torch.int32))


@pytest.mark.parametrize("b,h,d,levels", [(4, 30, 200, 16), (6, 49, 97, 2), (3, 20, 40, 256)])
def test_uhd_datapaths_equal_jax(b, h, d, levels):
    rng = np.random.default_rng(b + d)
    x = rng.integers(0, levels + 1, (b, h)).astype(np.int32)
    s = rng.integers(0, levels, (h, d)).astype(np.int32)
    xj, sj = jnp.asarray(x), jnp.asarray(s)
    want = np.asarray(jenc.uhd_encode(xj, sj))
    np.testing.assert_array_equal(tenc.uhd_encode(_t(x), _t(s)).numpy(), want)
    for jf, tf in [
        (jenc.uhd_encode_blocked(xj, sj, 64), tenc.uhd_encode_blocked(_t(x), _t(s), 64)),
        (jenc.uhd_encode_unary_matmul(xj, sj, levels),
         tenc.uhd_encode_unary_matmul(_t(x), _t(s), levels)),
        (jenc.uhd_encode_via_unary_comparator(xj, sj, levels),
         tenc.uhd_encode_via_unary_comparator(_t(x), _t(s), levels)),
    ]:
        np.testing.assert_array_equal(np.asarray(jf), want)
        np.testing.assert_array_equal(tf.numpy(), want)


@pytest.mark.parametrize("n_bits", [1, 16, 33, 64])
def test_unary_streams_and_comparator_equal_jax(n_bits):
    rng = np.random.default_rng(n_bits)
    a = rng.integers(0, n_bits + 1, (7, 5)).astype(np.int32)
    b = rng.integers(0, n_bits + 1, (7, 5)).astype(np.int32)
    therm = tunary.to_thermometer(_t(a), n_bits)
    np.testing.assert_array_equal(therm.numpy(), np.asarray(junary.to_thermometer(jnp.asarray(a), n_bits)))
    np.testing.assert_array_equal(tunary.from_thermometer(therm).numpy(), a)
    ust = tunary.unary_stream_table(n_bits)
    np.testing.assert_array_equal(
        ust.numpy().view(np.uint32), np.asarray(junary.unary_stream_table(n_bits))
    )
    aw, bw = tunary.fetch_unary(_t(a), ust), tunary.fetch_unary(_t(b), ust)
    jaw = junary.fetch_unary(jnp.asarray(a), junary.unary_stream_table(n_bits))
    jbw = junary.fetch_unary(jnp.asarray(b), junary.unary_stream_table(n_bits))
    np.testing.assert_array_equal(aw.numpy().view(np.uint32), np.asarray(jaw))
    np.testing.assert_array_equal(tunary.unary_ge(aw, bw, n_bits).numpy(), a >= b)
    np.testing.assert_array_equal(
        tunary.unary_ge(aw, bw, n_bits).numpy(), np.asarray(junary.unary_ge(jaw, jbw, n_bits))
    )
    np.testing.assert_array_equal(
        tunary.unary_min(aw, bw).numpy().view(np.uint32), np.asarray(junary.unary_min(jaw, jbw))
    )


# ---------------------------------------------------------------------------
# Kernel 8: bundling with the fused sign
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,c,d", [(10, 10, 512), (64, 3, 300), (7, 12, 1024)])
@pytest.mark.parametrize("binarize", [True, False])
def test_bundle_binarize_equals_jax(b, c, d, binarize):
    rng = np.random.default_rng(b * c + d)
    hvs = rng.integers(-50, 50, (b, d)).astype(np.int32)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[b // 2] = c  # out of range: dropped from the sums by both packages
    want = np.asarray(jops.bundle_binarize(jnp.asarray(hvs), jnp.asarray(labels), c,
                                           binarize=binarize))
    got = tops.bundle_binarize(_t(hvs), _t(labels), c, binarize=binarize)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    onehot = tref.class_onehot(_t(labels), c)
    np.testing.assert_array_equal(tref.bundle_binarize(_t(hvs), onehot, binarize=binarize).numpy(), want)
    if binarize:
        np.testing.assert_array_equal(
            np.asarray(jref.bundle_binarize(jnp.asarray(hvs), jnp.asarray(onehot.numpy()))), want
        )
    else:
        np.testing.assert_array_equal(
            np.asarray(jenc.bundle_by_class(jnp.asarray(hvs), jnp.asarray(labels), c)), want
        )
        np.testing.assert_array_equal(tenc.bundle_by_class(_t(hvs), _t(labels), c).numpy(), want)


def test_bundle_binarize_is_exact_past_float32s_integer_window():
    """The port sums exactly where the JAX kernel's float32 would round:
    class sums far past 2**24, against int64 numpy."""
    rng = np.random.default_rng(0)
    b, c, d = 3000, 3, 16
    hvs = rng.integers(2**20 - 7, 2**20, (b, d)).astype(np.int32)
    hvs[:, ::2] *= -1
    labels = rng.integers(0, c, b).astype(np.int32)
    want = np.zeros((c, d), np.int64)
    np.add.at(want, labels, hvs.astype(np.int64))
    assert np.abs(want).max() > 2**24 * 32
    got = tops.bundle_binarize(_t(hvs), _t(labels), c, binarize=False)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    signs = tops.bundle_binarize(_t(hvs), _t(labels), c).numpy()
    np.testing.assert_array_equal(signs, np.where(want >= 0, 1, -1).astype(np.int8))


# ---------------------------------------------------------------------------
# The baseline model against the JAX package's
# ---------------------------------------------------------------------------

D_MODEL = 512


@pytest.fixture(scope="module")
def pair():
    if jax is None:
        pytest.skip("needs the JAX package")
    ds = tload("synth_mnist", n_train=256, n_test=128)
    kw = dict(n_features=ds.n_features, n_classes=ds.n_classes, d=D_MODEL, levels=16,
              encoder="baseline", seed=2)
    half = len(ds.train_images) // 2
    steps = [(ds.train_images[:half], ds.train_labels[:half]),
             (ds.train_images[half:], ds.train_labels[half:])]
    jm = [jhm.fit(JModel.create(JConfig(**kw)), jnp.asarray(steps[0][0]), jnp.asarray(steps[0][1]))]
    jm.append(jhm.partial_fit(jm[0], jnp.asarray(steps[1][0]), jnp.asarray(steps[1][1])))
    tm = [HDCModel.create(HDCConfig(**kw), device="cpu").fit(*steps[0])]
    tm.append(tm[0].partial_fit(*steps[1]))
    return ds, jm, tm


def _jax_top2_margins(jm, images) -> np.ndarray:
    sim = np.asarray(jax.jit(
        lambda m, im: jmetrics.cosine_similarity(jhm._encode(m, im), m.class_hvs)
    )(jm, jnp.asarray(images)))
    top2 = np.sort(sim, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _assert_cosine_labels_near_jax(jm, got, images, max_differ=2):
    want = np.asarray(jm.predict(jnp.asarray(images)))
    differ = np.nonzero(got != want)[0]
    assert len(differ) <= max_differ, differ
    if len(differ):
        assert (_jax_top2_margins(jm, images[differ]) < 1e-6).all()


def test_baseline_model_policies_and_codebooks_equal_jax(pair):
    _, jm, tm = pair
    assert tm[1].cfg.resolved_class_binarize == jm[1].cfg.resolved_class_binarize == "sign"
    assert tm[1].cfg.resolved_pack_center == jm[1].cfg.resolved_pack_center == "none"
    for k in ("p", "level"):
        np.testing.assert_array_equal(tm[1].codebooks[k].numpy(), np.asarray(jm[1].codebooks[k]))
    specs = treg.get_encoder("baseline").codebook_specs(tm[1].cfg)
    assert {k: (tuple(v.shape), v.numpy().dtype) for k, v in tm[1].codebooks.items()} == specs
    np.testing.assert_array_equal(tm[1].class_hvs.numpy(), np.asarray(jm[1].class_hvs))


@pytest.mark.parametrize("step", [0, 1])
def test_baseline_fit_and_partial_fit_class_sums_equal_jax(pair, step):
    _, jm, tm = pair
    np.testing.assert_array_equal(tm[step].class_sums.numpy(), np.asarray(jm[step].class_sums))
    assert tm[step].n_examples == int(jhm._nseen_int(jm[step].n_seen))


def test_baseline_hamming_and_packed_labels_equal_jax(pair):
    ds, jm, tm = pair
    x = ds.test_images
    jh = jm[1].replace(cfg=dataclasses.replace(jm[1].cfg, similarity="hamming"))
    th = HDCModel(dataclasses.replace(tm[1].cfg, similarity="hamming"), tm[1].codebooks,
                  tm[1].class_sums, tm[1].n_seen, device="cpu")
    want = np.asarray(jh.predict(jnp.asarray(x)))
    np.testing.assert_array_equal(th.predict(x).numpy(), want)
    np.testing.assert_array_equal(np.asarray(tm[1].pack()).view(np.uint32), np.asarray(jm[1].pack()))
    packed = thm.predict_packed(tm[1], x, tm[1].pack()).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jhm.predict_packed(jm[1], jnp.asarray(x), jm[1].pack())))
    np.testing.assert_array_equal(packed, want)


def test_baseline_cosine_labels_differ_only_on_float32_near_ties(pair):
    ds, jm, tm = pair
    _assert_cosine_labels_near_jax(jm[1], tm[1].predict(ds.test_images).numpy(), ds.test_images)


def test_jax_baseline_checkpoint_loads_in_port_and_back(pair, tmp_path):
    ds, jm, tm = pair
    jm[1].save(tmp_path / "jax", step=3)
    loaded = HDCModel.load(tmp_path / "jax", device="cpu")
    assert loaded.cfg == tm[1].cfg and loaded.n_examples == tm[1].n_examples
    for k in ("p", "level"):
        assert loaded.codebooks[k].dtype == torch.int8
        assert torch.equal(loaded.codebooks[k], tm[1].codebooks[k])
    assert torch.equal(loaded.class_sums, tm[1].class_sums)
    x = ds.test_images
    np.testing.assert_array_equal(
        thm.predict_packed(loaded, x, loaded.pack()).numpy(),
        np.asarray(jhm.predict_packed(jm[1], jnp.asarray(x), jm[1].pack())),
    )
    tm[1].save(tmp_path / "torch", step=1)
    back = JModel.load(tmp_path / "torch")
    assert back.cfg == jm[1].cfg
    for k in ("p", "level"):
        assert back.codebooks[k].dtype == jm[1].codebooks[k].dtype
        np.testing.assert_array_equal(np.asarray(back.codebooks[k]), np.asarray(jm[1].codebooks[k]))
    np.testing.assert_array_equal(np.asarray(back.class_sums), np.asarray(jm[1].class_sums))
    np.testing.assert_array_equal(np.asarray(back.predict(jnp.asarray(x))),
                                  np.asarray(jm[1].predict(jnp.asarray(x))))


def test_baseline_does_not_convert_to_uhd(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="cannot convert encoder 'baseline'"):
        tm[1].convert("uhd")
    uhd = HDCModel.create(dataclasses.replace(tm[1].cfg, encoder="uhd"), device="cpu")
    with pytest.raises(ValueError, match="cannot convert encoder 'uhd'"):
        uhd.convert("baseline")


def test_baseline_iterative_search_equals_jax_per_seed():
    ds = tload("synth_mnist", n_train=200, n_test=64)
    base = dict(n_features=ds.n_features, n_classes=ds.n_classes, d=256, levels=16)
    args = (ds.train_images, ds.train_labels, ds.test_images, ds.test_labels)
    jmodels = []
    for i in range(2):
        jcfg = JConfig(**base, encoder="baseline", seed=i)
        jmodels.append(JModel.create(jcfg).fit_batches(
            (ds.train_images[j : j + 128], ds.train_labels[j : j + 128]) for j in range(0, 200, 128)
        ))
    jaccs = jhm.baseline_iterative_search(JConfig(**base), *args, iterations=2, batch_size=128)
    seen = []
    accs = thm.baseline_iterative_search(
        HDCConfig(**base, backend="ref"), *args, iterations=2, batch_size=128, device="cpu",
        on_model=lambda i, m: seen.append((i, m)),
    )
    assert [i for i, _ in seen] == [0, 1]
    for (i, tm), jm, jacc, acc in zip(seen, jmodels, jaccs, accs):
        assert tm.cfg.encoder == "baseline" and tm.cfg.seed == i and tm.cfg.backend == "auto"
        np.testing.assert_array_equal(tm.class_sums.numpy(), np.asarray(jm.class_sums))
        _assert_cosine_labels_near_jax(jm, tm.predict(ds.test_images).numpy(), ds.test_images)
        assert abs(acc - jacc) <= 2 / len(ds.test_images)


@pytest.mark.parametrize("data,model_axis", [(1, 4), (2, 2)])
def test_partial_fit_sharded_baseline_on_four_cpu_cells_equals_partial_fit(pair, data, model_axis):
    ds, jm, tm = pair
    mesh = mesh_for(4, model_axis, devices=["cpu"] * 4)
    assert mesh.shape == {"data": data, "model": model_axis}
    half = len(ds.train_images) // 2
    sharded = HDCModel.create(tm[0].cfg, device="cpu")
    for sl in (slice(0, half), slice(half, None)):
        sharded = partial_fit_sharded(sharded, ds.train_images[sl], ds.train_labels[sl], mesh=mesh)
    assert sharded.n_shards == model_axis and sharded.d_local == D_MODEL // model_axis
    assert torch.equal(sharded.class_sums, tm[1].class_sums)
    np.testing.assert_array_equal(sharded.class_sums.numpy(), np.asarray(jm[1].class_sums))
    for k, v in tm[1].codebooks.items():
        assert torch.equal(sharded.codebooks[k], v), k


# ---------------------------------------------------------------------------
# Repairs: manifests the JAX package accepts; no plain top-k on a card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoder", ["uhd", "uhd_dynamic", "baseline"])
@pytest.mark.parametrize("backend", ["auto", "cuda", "ref"])
def test_manifest_of_every_encoder_and_backend_constructs_the_jax_config(encoder, backend):
    assert backend == "auto" or backend in treg.backend_names(encoder)
    raw = manifest_config(HDCConfig(n_features=4, n_classes=2, encoder=encoder, backend=backend))
    assert raw["backend"] == "auto" or raw["backend"] in jbackend_names(encoder)
    want = {"cuda": "pallas" if encoder != "baseline" else "auto",
            "ref": "ref" if encoder == "uhd_dynamic" else "auto", "auto": "auto"}[backend]
    assert raw["backend"] == want
    JConfig(**raw)


def test_port_uhd_model_saved_with_ref_backend_loads_in_jax(tmp_path):
    ds = tload("synth_mnist", n_train=64, n_test=32)
    cfg = HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=128, encoder="uhd",
                    backend="ref")
    tm = HDCModel.create(cfg, device="cpu").fit(ds.train_images, ds.train_labels)
    tm.save(tmp_path, step=0)
    back = JModel.load(tmp_path)
    assert back.cfg.backend == "auto"
    x = ds.test_images
    np.testing.assert_array_equal(
        np.asarray(jhm.predict_packed(back, jnp.asarray(x), back.pack())),
        thm.predict_packed(tm, x, tm.pack()).numpy(),
    )


def test_topk_without_a_registered_datapath_dispatches_by_device(monkeypatch):
    """A backend that registers no top-k goes through ``ops.hamming_topk``
    (kernel on a card, plain version on the CPU), never straight to the
    plain version."""
    calls = []
    real = tops.hamming_topk

    def spy(*a):
        calls.append(a[0].device)
        return real(*a)

    monkeypatch.setattr(tops, "hamming_topk", spy)
    rng = np.random.default_rng(0)
    q = _t(rng.integers(-2**31, 2**31, (3, 4), dtype=np.int64).astype(np.int32))
    rows = _t(rng.integers(-2**31, 2**31, (9, 4), dtype=np.int64).astype(np.int32))
    spec = treg._BACKENDS["baseline"]["ref"]
    assert spec.topk is None
    idx, dist = treg.get_encoder("baseline").topk(q, rows, 128, 3)
    assert calls == [torch.device("cpu")]
    want_i, want_d = tref.hamming_topk_oracle(q, rows, 128, 3)
    assert torch.equal(idx, want_i) and torch.equal(dist, want_d)


def test_fit_bundle_fallback_refuses_a_point_offset():
    cfg = HDCConfig(n_features=6, n_classes=2, d=64, encoder="baseline")
    books = treg.get_encoder("baseline").build_codebooks(cfg)
    x = torch.zeros((2, 6), dtype=torch.int32)
    y = torch.zeros(2, dtype=torch.int32)
    sums = treg.get_encoder("baseline").fit_bundle(cfg, books, x, y)
    assert sums.shape == (2, 64) and sums.dtype == torch.int32
    with pytest.raises(ValueError, match="no fused fit_bundle"):
        treg.get_encoder("baseline").fit_bundle(cfg, books, x, y, point_offset=0)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def test_serve_hdc_smoke_baseline_equals_jax(tmp_path):
    args = tserve.parser().parse_args([
        "--smoke", "--encoder", "baseline", "--d", "256", "--n-train", "128",
        "--requests", "32", "--batch", "8", "--device", "cpu", "--ckpt", str(tmp_path),
    ])
    r = tserve.smoke(args)
    ds = tload("synth_mnist", n_train=128, n_test=32)
    cfg = JConfig(n_features=784, n_classes=10, d=256, levels=16, encoder="baseline")
    j0 = JModel.create(cfg).fit(ds.train_images[:64], ds.train_labels[:64])
    j1 = j0.partial_fit(ds.train_images[64:], ds.train_labels[64:])
    for tm, jm in zip(r.models, (j0, j1)):
        np.testing.assert_array_equal(tm.class_sums.numpy(), np.asarray(jm.class_sums))
    want = np.concatenate([
        np.asarray(jhm.predict_packed(j0, jnp.asarray(ds.test_images[:16]), j0.pack())),
        np.asarray(jhm.predict_packed(j1, jnp.asarray(ds.test_images[16:]), j1.pack())),
    ])
    assert r.accuracy == float((want == ds.test_labels).mean())


def test_train_hdc_compare_baseline_prints_jax_form(capsys):
    ttrain.main(["--device", "cpu", "--d", "128", "--n-train", "160", "--n-test", "64",
                 "--batch-size", "100", "--encoder", "baseline", "--compare-baseline",
                 "--baseline-iters", "2"])
    out = capsys.readouterr().out
    ds = tload("synth_mnist", n_train=160, n_test=64)
    jaccs = jhm.baseline_iterative_search(
        JConfig(n_features=784, n_classes=10, d=128), ds.train_images, ds.train_labels,
        ds.test_images, ds.test_labels, iterations=2, batch_size=100,
    )
    line = next(s for s in out.splitlines() if s.startswith("baseline HDC over i=1..2: "))
    avg, best = (float(v) for v in line.split("avg ")[1].split(" (")[0].split(" best "))
    assert abs(avg - np.mean(jaccs)) <= 2 / 64 + 1e-4 and abs(best - np.max(jaccs)) <= 2 / 64 + 1e-4
    assert line.endswith("s, 2 full retrains)")
    assert "baseline  D=128 device=cpu" in out


def test_train_hdc_cli_baseline_round_trips(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_hdc", "--device", "cpu", "--d", "128",
         "--n-train", "128", "--n-test", "32", "--encoder", "baseline",
         "--save-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "round-trip ok: True" in out.stdout
    loaded = JModel.load(tmp_path)
    assert loaded.cfg.encoder == "baseline" and loaded.cfg.backend == "auto"


# ---------------------------------------------------------------------------
# Kernel 7's per-model operand [P == L], built once per codebook set
# ---------------------------------------------------------------------------


def _small_baseline(seed: int = 3) -> tuple[HDCConfig, object]:
    ds = tload("synth_mnist", n_train=128, n_test=64)
    return HDCConfig(n_features=784, n_classes=10, d=256, encoder="baseline", seed=seed), ds


def test_baseline_operand_cache_builds_once_across_fit_partial_fit_predict():
    cfg, ds = _small_baseline()
    cache = tenc.BASELINE_OPERANDS
    m0 = HDCModel.create(cfg, device="cpu")
    before = cache.builds
    m1 = m0.fit(ds.train_images[:64], ds.train_labels[:64])
    m2 = m1.partial_fit(ds.train_images[64:], ds.train_labels[64:])
    m2.predict(ds.test_images)
    thm.predict_packed(m2, ds.test_images, m2.pack())
    assert cache.builds - before == 1
    p, level = m2.codebooks["p"], m2.codebooks["level"]
    assert p is m0.codebooks["p"] and level is m0.codebooks["level"]  # the chain hands them on
    assert torch.equal(cache.get(p, level), tref.baseline_onehot_t(p, level))
    assert cache.builds - before == 1


@pytest.mark.parametrize("change", ["seed", "p_in_place", "level_in_place", "copies"])
def test_baseline_operand_cache_rebuilds_for_other_or_edited_codebooks(change):
    cfg, ds = _small_baseline()
    model = HDCModel.create(cfg, device="cpu")
    x = model.quantize(ds.test_images[:9])
    books = model.codebooks
    tenc.baseline_encode(x, books["p"], books["level"])
    before = tenc.BASELINE_OPERANDS.builds
    if change == "seed":
        books = HDCModel.create(dataclasses.replace(cfg, seed=4), device="cpu").codebooks
    elif change == "p_in_place":
        books["p"][5].neg_()  # through a view: the buffer's version moves
    elif change == "level_in_place":
        books["level"][3, ::2].neg_()
    else:
        books = {k: v.clone() for k, v in books.items()}
    got = tenc.baseline_encode(x, books["p"], books["level"])
    assert tenc.BASELINE_OPERANDS.builds == before + 1
    assert torch.equal(got, tenc.baseline_encode_naive(x, books["p"], books["level"]))
    tenc.baseline_encode(x, books["p"], books["level"])
    assert tenc.BASELINE_OPERANDS.builds == before + 1


def test_baseline_operand_cache_entry_goes_with_its_codebooks():
    cfg, _ = _small_baseline(seed=5)
    books = HDCModel.create(cfg, device="cpu").codebooks
    cache = tenc.BASELINE_OPERANDS
    cache.get(books["p"], books["level"])
    n = len(cache._entries)
    del books
    import gc

    gc.collect()
    assert len(cache._entries) == n - 1


def test_train_compare_baseline_keeps_no_retrained_model_or_operand():
    """``train_hdc --compare-baseline`` hands each retrain to ``on_retrain`` and
    keeps none: after it returns, no retrained model, codebook or [P == L]
    cache entry of one is alive (each would hold 109 MB of O' on a card at
    D = 8192)."""
    import gc
    import weakref

    args = ttrain.parser().parse_args([
        "--device", "cpu", "--d", "256", "--n-train", "256", "--n-test", "64",
        "--batch-size", "128", "--encoder", "baseline", "--compare-baseline",
        "--baseline-iters", "3",
    ])
    cache = tenc.BASELINE_OPERANDS
    seen, books = [], []

    def on_retrain(i, model):
        seen.append((i, weakref.ref(model)))
        books.append(tuple(weakref.ref(model.codebooks[k]) for k in ("p", "level")))
        assert (id(model.codebooks["p"]), id(model.codebooks["level"])) in cache._entries

    result = ttrain.train(args, on_retrain=on_retrain)
    assert [i for i, _ in seen] == [0, 1, 2] and len(result.baseline_accs) == 3
    assert not hasattr(result, "baseline_models")
    gc.collect()
    assert all(ref() is None for _, ref in seen)
    assert all(p() is None and level() is None for p, level in books)
    # an entry goes with its P: none is left whose codebooks are gone
    assert all(entry[0]() is not None for entry in cache._entries.values())


def _tree(root: Path) -> dict[str, bytes]:
    return {str(f.relative_to(root)): f.read_bytes() for f in sorted(root.rglob("*")) if f.is_file()}


def test_operand_cache_leaves_checkpoints_unchanged_and_loadable_in_jax(pair, tmp_path):
    import json

    ds, jm, tm = pair
    cache = tenc.BASELINE_OPERANDS
    cache.clear()
    tm[1].save(tmp_path / "cold", step=1)
    tm[1].predict(ds.test_images)  # fills the cache for these codebooks
    before = cache.builds
    cache.get(tm[1].codebooks["p"], tm[1].codebooks["level"])
    assert cache.builds == before  # the entry is there
    tm[1].save(tmp_path / "warm", step=1)
    cold, warm = _tree(tmp_path / "cold"), _tree(tmp_path / "warm")
    assert sorted(cold) == sorted(warm)
    for name in cold:
        if name.endswith(".json"):  # the manifest: equal but for its time stamp
            a, b = json.loads(cold[name]), json.loads(warm[name])
            a.pop("time", None), b.pop("time", None)
            assert a == b
        else:
            assert cold[name] == warm[name], name
    back = JModel.load(tmp_path / "warm")
    assert set(back.codebooks) == {"p", "level"}
    np.testing.assert_array_equal(np.asarray(back.class_sums), np.asarray(jm[1].class_sums))
    np.testing.assert_array_equal(np.asarray(back.predict(jnp.asarray(ds.test_images))),
                                  np.asarray(jm[1].predict(jnp.asarray(ds.test_images))))


@pytest.mark.parametrize("b,h,d,levels,seed", [(5, 37, 300, 16, 0), (9, 784, 256, 16, 1),
                                               (3, 113, 130, 2, 2)])
def test_cached_baseline_encode_equals_jax(b, h, d, levels, seed):
    rng = np.random.default_rng(b + h + d)
    x = rng.integers(0, levels + 1, (b, h)).astype(np.int32)
    p, level = tenc.make_baseline_codebooks(prng.prng_key(seed), h, d, levels)
    jp, jl = jenc.make_baseline_codebooks(jax.random.PRNGKey(seed), h, d, levels)
    want = np.asarray(jenc.baseline_encode(jnp.asarray(x), jp, jl))
    before = tenc.BASELINE_OPERANDS.builds
    for _ in range(2):  # the first call builds [P == L], the second reads it back
        np.testing.assert_array_equal(tenc.baseline_encode(_t(x), p, level).numpy(), want)
    assert tenc.BASELINE_OPERANDS.builds == before + 1


# ---------------------------------------------------------------------------
# On a card: kernels 7 and 8 against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,k,d", [(5, 1600, 700), (64, 12544, 8192), (130, 13344, 100), (3, 48, 33), (1, 45, 9)]
)
def test_cuda_encode_unary_mxu_equals_plain(cuda, b, k, d):
    rng = np.random.default_rng(b + k + d)
    u = _t(rng.integers(0, 2, (b, k)).astype(np.int8)).to(cuda)
    o = _t(rng.integers(0, 2, (d, k)).astype(np.int8)).to(cuda)
    got = tops.encode_unary_mxu_operands(u, o, 784)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.encode_unary_mxu(u, o, 784))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,c,d",
    [(7, 12, 1000), (512, 10, 8192), (300, 300, 65), (0, 3, 40),
     # fewer rows than a cluster has blocks, the training step's batch, a batch that
     # splits unevenly; one class and two C tiles; ragged D (element loads)
     (1, 10, 8192), (2048, 10, 8192), (4097, 10, 2042), (7, 1, 1000), (300, 257, 2042),
     (64, 257, 1000)],
)
@pytest.mark.parametrize("binarize", [True, False])
def test_cuda_bundle_binarize_equals_plain(cuda, b, c, d, binarize):
    rng = np.random.default_rng(b + c + d)
    hv = _t(rng.integers(-784, 785, (b, d)).astype(np.int32)).to(cuda)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[::5] = -1
    labels[2::7] = c
    lab = _t(labels).to(cuda)
    tops.reset_launches()
    got = tops.bundle_binarize(hv, lab, c, binarize=binarize)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.bundle_binarize(hv, tref.class_onehot(lab, c), binarize=binarize))
    # one launch, on a cluster of 1 to 8 blocks along B
    (key,) = tops.LAUNCH_SHAPES["bundle_binarize"]
    assert tops.LAUNCHES["bundle_binarize"] == 1 and key.split()[-1] in {
        f"cluster={n}" for n in (1, 2, 4, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1000, 2048])
def test_cuda_bundle_binarize_sums_reach_int32_limits(cuda, d):
    # class 0 sums to 2**31 - 1 and class 1 to -(2**31 - 1), each through partial sums
    # that pass the int32 range (the adds wrap, in whatever order the blocks take them);
    # class 2 sums to 0 (its sign is +1); the rows spread over every block of a cluster
    m = 2**31 - 1
    b = 4096
    hv = np.zeros((b, d), dtype=np.int64)
    labels = np.full(b, 2, dtype=np.int32)
    for cls, sign, rows in ((0, 1, (5, 1500, 4000)), (1, -1, (6, 2047, 4095))):
        labels[list(rows)] = cls
        hv[rows[0]] = hv[rows[1]] = sign * m
        hv[rows[2]] = -sign * m
    hv[labels == 2, ::7] = 3
    hv[np.flatnonzero(labels == 2)[::2], ::7] = -3
    hvt = _t(hv.astype(np.int32)).to(cuda)
    lab = _t(labels).to(cuda)
    sums = tops.bundle_binarize(hvt, lab, 3, binarize=False)
    signs = tops.bundle_binarize(hvt, lab, 3, binarize=True)
    torch.cuda.synchronize()
    assert torch.equal(sums, tref.bundle_binarize(hvt, tref.class_onehot(lab, 3), binarize=False))
    assert (sums[0] == m).all() and (sums[1] == -m).all() and (sums[2] == 0).all()
    assert signs.tolist() == [[1] * d, [-1] * d, [1] * d]


@pytest.mark.cuda
def test_cuda_baseline_model_equals_cpu_and_launches_kernels_7_8_5(cuda):
    ds = tload("synth_mnist", n_train=128, n_test=64)
    cfg = HDCConfig(n_features=784, n_classes=10, d=1024, encoder="baseline", seed=1)
    cpu = HDCModel.create(cfg, device="cpu").fit(ds.train_images, ds.train_labels)
    tops.reset_launches()
    card = HDCModel.create(cfg, device=cuda).fit(ds.train_images, ds.train_labels)
    labels = thm.predict_packed(card, ds.test_images, card.pack())
    torch.cuda.synchronize()
    assert tops.LAUNCHES["encode_unary_mxu"] == 2 and tops.LAUNCHES["bundle_binarize"] == 1
    assert tops.LAUNCHES["hamming_topk"] == 1
    assert torch.equal(card.class_sums.cpu(), cpu.class_sums)
    assert torch.equal(labels.cpu(), thm.predict_packed(cpu, ds.test_images, cpu.pack()))
