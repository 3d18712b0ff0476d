"""The ``uhd`` table encoder of the port against the JAX package's.

Inputs are made with numpy from a seed (or by the byte-identical
synthetic datasets) and handed to both packages; the JAX side runs on
the CPU, its Pallas ops in interpret mode as its own tests run them.
Every datapath compared here is integer arithmetic or sign bits, so
every comparison is **exact equality** (tolerance 0).  The one float32
path, cosine ``predict``, is held to the class sums exactly and to its
labels up to float32 near-ties (``test_cosine_labels_differ_only_on_float32_near_ties``).
Tests marked ``cuda`` hold the two table kernels against their plain
versions on a card and skip without one.
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch import convert
from repro_torch.core import HDCConfig, HDCModel, ItemMemory
from repro_torch.core import encoding as tenc
from repro_torch.core import hdc_model as thm
from repro_torch.core import registry as treg
from repro_torch.core import sobol as tsobol
from repro_torch.core import unary as tunary
from repro_torch.data import load_dataset as tload
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

try:  # a machine with a card runs the cuda-marked tests alone, and may have no JAX
    import jax
    import jax.numpy as jnp

    from repro.core import HDCConfig as JConfig
    from repro.core import HDCModel as JModel
    from repro.core import ItemMemory as JItemMemory
    from repro.core import encoding as jenc
    from repro.core import encoders as jencoders
    from repro.core import hdc_model as jhm
    from repro.core import metrics as jmetrics
    from repro.core import sobol as jsobol
    from repro.data import load_dataset as jload
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ModuleNotFoundError:
    jax = None

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def jax_side():
    if jax is None:
        pytest.skip("needs the JAX package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Sobol table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "h,d,levels,seed,skip",
    [(1, 1, 2, 0, 1), (49, 300, 16, 0, 1), (113, 1000, 16, 3, 5), (20, 257, 256, 1, 0),
     (7, 64, 2**16, 2, 1000)],
)
def test_sobol_table_equals_jax(jax_side, h, d, levels, seed, skip):
    kw = dict(seed=seed, skip=skip)
    got = tsobol.sobol_table_for_features(h, d, levels, **kw)
    want = jsobol.sobol_table_for_features(h, d, levels, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsobol.sobol_table_for_features(h, d, **kw), jsobol.sobol_table_for_features(h, d, **kw)
    )
    np.testing.assert_array_equal(
        tsobol.sobol_integers(h, d, **kw), jsobol.sobol_integers(h, d, **kw)
    )
    # the encoder's stored table: int8 up to 127 levels, int32 above
    cfg_kw = dict(n_features=h, n_classes=2, d=d, levels=levels, seed=seed, sobol_skip=skip)
    got = treg.get_encoder("uhd").build_codebooks(HDCConfig(**cfg_kw))["sobol"]
    want = np.asarray(jencoders.UHDEncoder().build_codebooks(JConfig(**cfg_kw))["sobol"])
    assert got.numpy().dtype == want.dtype == (np.int8 if levels <= 127 else np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    spec = treg.get_encoder("uhd").codebook_specs(HDCConfig(**cfg_kw))["sobol"]
    assert spec == ((h, d), want.dtype)


# ---------------------------------------------------------------------------
# Kernels' plain versions against the JAX package's ref and Pallas ops
# ---------------------------------------------------------------------------


def _table_inputs(seed: int, b: int, h: int, d: int, levels: int, n_classes: int = 10):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, levels + 1, (b, h)).astype(np.int32)
    labels = rng.integers(0, n_classes, b).astype(np.int32)
    dtype = np.int8 if levels <= 127 else np.int32
    table = tsobol.sobol_table_for_features(h, d, levels, seed=seed).astype(dtype)
    return x, labels, table


# (B, H, D, levels, C): ragged in every dimension, int8 and int32 tables
_SHAPES = [
    (1, 49, 300, 16, 2),
    (5, 113, 1000, 16, 10),
    (37, 49, 1000, 256, 10),
    (37, 113, 257, 2, 3),
]


@pytest.mark.parametrize("b,h,d,levels,c", _SHAPES)
def test_encode_bundle_equals_jax(jax_side, b, h, d, levels, c):
    x, _, table = _table_inputs(b * 7 + h, b, h, d, levels)
    xj, sj = jnp.asarray(x), jnp.asarray(table)
    want = np.asarray(jref.encode_bundle(xj, sj))
    np.testing.assert_array_equal(np.asarray(jops.encode_bundle(xj, sj)), want)
    xt, st = torch.from_numpy(x), torch.from_numpy(table)
    for got in (tref.encode_bundle(xt, st), tops.encode_bundle(xt, st), tenc.uhd_encode(xt, st),
                tref.encode_bundle(xt, st, block_d=128)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jenc.uhd_encode(xj, sj)), want)


@pytest.mark.parametrize("b,h,d,levels,c", _SHAPES)
def test_fit_bundle_equals_jax(jax_side, b, h, d, levels, c):
    x, labels, table = _table_inputs(b * 11 + h, b, h, d, levels, n_classes=c)
    labels[::5] = -1  # out of range: contributes nothing in either package
    labels[2::7] = c
    args = (jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels), c)
    want = np.asarray(jref.fit_bundle(*args))
    np.testing.assert_array_equal(np.asarray(jops.fit_bundle(*args)), want)
    targs = (torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(labels), c)
    for got in (tref.fit_bundle(*targs), tops.fit_bundle(*targs),
                tref.fit_bundle(*targs, block_d=96)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    keep = (labels >= 0) & (labels < c)
    hv = tref.encode_bundle(torch.from_numpy(x[keep]), torch.from_numpy(table))
    np.testing.assert_array_equal(
        tenc.bundle_by_class(hv, torch.from_numpy(labels[keep]), c).numpy(), want
    )


@pytest.mark.parametrize("d", [2040, 2044])
def test_encode_bundle_full_range_int8_equals_jax(jax_side, d):
    # the D-shard widths with int8 entries in [-128, 127] and any int32 x: both
    # packages compare x with the sign-extended entry
    x, _, table = _full_range_case(d, 9, 49, d, 3)
    want = np.asarray(jref.encode_bundle(jnp.asarray(x), jnp.asarray(table)))
    xt, st = torch.from_numpy(x), torch.from_numpy(table)
    for got in (tref.encode_bundle(xt, st), tops.encode_bundle(xt, st)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_table_and_generated_thresholds_agree():
    """The table of ``uhd`` holds exactly the thresholds ``uhd_dynamic``
    generates from the same seed and skip."""
    b, h, d, skip = 6, 49, 300, 7
    x, _, _ = _table_inputs(1, b, h, d, 16)
    table = tsobol.sobol_table_for_features(h, d, 16, skip=skip).astype(np.int8)
    dirs = tsobol.quantized_direction_matrix(h, 16)
    np.testing.assert_array_equal(
        tref.encode_bundle(torch.from_numpy(x), torch.from_numpy(table)).numpy(),
        tref.encode_bundle_dynamic(torch.from_numpy(x), torch.from_numpy(dirs), d, skip=skip).numpy(),
    )


def test_table_wrappers_reject_bad_operands():
    x = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        tops.encode_bundle(x, torch.zeros((3, 4), dtype=torch.int8, device="meta"))
    for bad in (torch.zeros((3, 4), dtype=torch.int16), torch.zeros((4, 4), dtype=torch.int8)):
        with pytest.raises(ValueError):
            tops._table_args(x, bad)


# ---------------------------------------------------------------------------
# A uhd model through both packages
# ---------------------------------------------------------------------------

N_TRAIN, N_TEST = 240, 48


@pytest.fixture(scope="module")
def data(jax_side):
    ds = jload("synth_mnist", n_train=N_TRAIN, n_test=N_TEST)
    mine = tload("synth_mnist", n_train=N_TRAIN, n_test=N_TEST)
    for f in ("train_images", "train_labels", "test_images", "test_labels"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ds, f))
    return ds


def _configs(**kw):
    kw = dict(dict(n_features=784, n_classes=10, encoder="uhd"), **kw)
    return JConfig(**kw), HDCConfig(**kw)


@pytest.fixture(scope="module", params=[(256, 1, 16), (1000, 5, 256)],
                ids=["d256", "d1000-skip5-levels256"])
def trained(request, data):
    """Both packages: fit on the first half, partial_fit on the second."""
    d, skip, levels = request.param
    jcfg, tcfg = _configs(d=d, sobol_skip=skip, levels=levels)
    half = N_TRAIN // 2
    x, y = data.train_images, data.train_labels
    j0 = JModel.create(jcfg).fit(x[:half], y[:half])
    t0 = HDCModel.create(tcfg, device="cpu").fit(x[:half], y[:half])
    j1, t1 = j0.partial_fit(x[half:], y[half:]), t0.partial_fit(x[half:], y[half:])
    return dict(j=(j0, j1), t=(t0, t1))


def test_uhd_class_sums_and_packed_words_equal_jax(trained, data):
    for jm, tm in zip(trained["j"], trained["t"]):
        assert tm.codebooks["sobol"].dtype == (torch.int8 if tm.cfg.levels <= 127 else torch.int32)
        np.testing.assert_array_equal(tm.codebooks["sobol"].numpy(), np.asarray(jm.codebooks["sobol"]))
        np.testing.assert_array_equal(tm.class_sums.numpy(), np.asarray(jm.class_sums))
        assert tm.n_examples == jm.n_examples
        np.testing.assert_array_equal(tm.pack().numpy().view(np.uint32), np.asarray(jm.pack()))
    # fit_batches over two batches equals fit on their concatenation, in both
    x, y = data.train_images, data.train_labels
    batches = [(x[:100], y[:100]), (x[100:], y[100:])]
    jm, tm = trained["j"][1], trained["t"][1]
    streamed = tm.fit_batches(batches)
    np.testing.assert_array_equal(streamed.class_sums.numpy(), np.asarray(jm.fit_batches(batches).class_sums))
    assert torch.equal(streamed.class_sums, tm.class_sums)


def test_uhd_packed_serving_and_hamming_predict_equal_jax(trained, data):
    jm, tm = trained["j"][1], trained["t"][1]
    x = data.test_images
    want = np.asarray(jhm.predict_packed(jm, jnp.asarray(x), jm.pack()))
    got = thm.predict_packed(tm, x, tm.pack())
    np.testing.assert_array_equal(got.numpy(), want)
    ji, jd = jhm.search_packed(jm, jnp.asarray(x), jm.pack(), k=4)
    ti, td = thm.search_packed(tm, x, tm.pack(), k=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jh = jm.replace(cfg=dataclasses.replace(jm.cfg, similarity="hamming"))
    th = HDCModel(dataclasses.replace(tm.cfg, similarity="hamming"), tm.codebooks,
                  tm.class_sums, tm.n_seen, device="cpu")
    np.testing.assert_array_equal(th.predict(x).numpy(), np.asarray(jh.predict(jnp.asarray(x))))
    np.testing.assert_array_equal(th.predict(x).numpy(), want)


def test_convert_within_the_family_both_ways(trained, data):
    jm, tm = trained["j"][1], trained["t"][1]
    dyn = tm.convert("uhd_dynamic")
    assert dyn.cfg.encoder == "uhd_dynamic" and dyn.cfg.backend == "auto"
    assert set(dyn.codebooks) == {"direction"} and dyn.n_examples == tm.n_examples
    assert torch.equal(dyn.class_sums, tm.class_sums)
    assert dyn.class_sums.data_ptr() != tm.class_sums.data_ptr()  # a copy, not shared state
    jdyn = jm.convert("uhd_dynamic")
    np.testing.assert_array_equal(
        dyn.codebooks["direction"].numpy(), np.asarray(jdyn.codebooks["direction"])
    )
    x = data.test_images
    assert torch.equal(dyn.encode(x), tm.encode(x))
    np.testing.assert_array_equal(
        thm.predict_packed(dyn, x, dyn.pack()).numpy(),
        np.asarray(jhm.predict_packed(jdyn, jnp.asarray(x), jdyn.pack())),
    )
    back = dyn.convert("uhd")
    assert back.cfg == tm.cfg
    assert torch.equal(back.codebooks["sobol"], tm.codebooks["sobol"])
    assert torch.equal(back.class_sums, tm.class_sums)


def test_convert_refuses_a_cross_family_target(trained, monkeypatch):
    class Other(treg.EncoderBase):
        family = "other"

    other = Other()
    other.name = "other_family"
    monkeypatch.setitem(treg._ENCODERS, "other_family", other)
    monkeypatch.setitem(treg._BACKENDS, "other_family", {})
    with pytest.raises(ValueError, match="cannot convert encoder 'uhd'"):
        trained["t"][1].convert("other_family")
    with pytest.raises(ValueError, match="cannot convert encoder 'uhd'"):
        trained["t"][1].convert("baseline")  # its own family: the class sums do not carry


def test_jax_uhd_checkpoint_loads_in_port_and_back(trained, data, tmp_path):
    jm, tm = trained["j"][1], trained["t"][1]
    jm.save(tmp_path / "jax", step=2)
    loaded = HDCModel.load(tmp_path / "jax", device="cpu")
    assert loaded.codebooks["sobol"].dtype == tm.codebooks["sobol"].dtype
    assert loaded.cfg == tm.cfg and loaded.n_examples == jm.n_examples
    x = data.test_images
    want = np.asarray(jhm.predict_packed(jm, jnp.asarray(x), jm.pack()))
    np.testing.assert_array_equal(thm.predict_packed(loaded, x, loaded.pack()).numpy(), want)
    tm.save(tmp_path / "torch", step=1)
    back = JModel.load(tmp_path / "torch")
    assert back.codebooks["sobol"].dtype == jm.codebooks["sobol"].dtype
    np.testing.assert_array_equal(np.asarray(back.class_sums), tm.class_sums.numpy())
    np.testing.assert_array_equal(
        np.asarray(jhm.predict_packed(back, jnp.asarray(x), back.pack())), want
    )


def test_model_from_jax_state_carries_the_table_dtype(trained):
    jm = trained["j"][1]
    cfg = {k: v for k, v in dataclasses.asdict(jm.cfg).items()
           if k not in ("use_kernels", "encode_impl")}
    state = {
        "codebooks/sobol": np.asarray(jm.codebooks["sobol"]),
        "class_sums": np.asarray(jm.class_sums),
        "n_seen": np.asarray(jm.n_seen),
    }
    tm = convert.model_from_jax_state(cfg, state, device="cpu")
    cfg2, state2 = convert.jax_state_from_model(tm)
    assert cfg2 == cfg and set(state2) == set(state)
    for k in state:
        assert state2[k].dtype == state[k].dtype
        np.testing.assert_array_equal(state2[k], state[k])
    bad = dict(state, **{"codebooks/sobol": state["codebooks/sobol"].astype(np.int16)})
    with pytest.raises(ValueError, match="codebook 'sobol'"):
        convert.model_from_jax_state(cfg, bad, device="cpu")


# ---------------------------------------------------------------------------
# train_hdc's data and batching (D cut to 1024): quantization, class sums,
# cosine labels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_hdc_pair(jax_side):
    """``train_hdc``'s defaults with D = 1024, through both packages."""
    ds = jload("synth_mnist", n_train=4096, n_test=1024)
    batches = [(ds.train_images[i : i + 2048], ds.train_labels[i : i + 2048])
               for i in range(0, 4096, 2048)]
    jcfg, tcfg = _configs(d=1024)
    jm = JModel.create(jcfg).fit_batches(batches)
    tm = HDCModel.create(tcfg, device="cpu").fit_batches(batches)
    return ds, jm, tm


def test_fit_batches_at_train_hdc_data_equals_jax(train_hdc_pair):
    """Regression: the port quantizes as the jitted JAX paths do, so the
    boundary pixel (image 533, pixel 471) lands in the same level and the
    class sums are equal (a dividing quantize moved 64 elements by 2)."""
    ds, jm, tm = train_hdc_pair
    np.testing.assert_array_equal(tm.class_sums.numpy(), np.asarray(jm.class_sums))
    assert tm.n_examples == jm.n_examples == 4096


def _jax_top2_margins(jm, images) -> np.ndarray:
    """JAX's float32 cosine margin between the best and second-best class
    of each image, computed as its jitted ``predict`` computes scores."""
    sim = np.asarray(jax.jit(
        lambda m, im: jmetrics.cosine_similarity(jhm._encode(m, im), m.class_hvs)
    )(jm, jnp.asarray(images)))
    top2 = np.sort(sim, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _assert_labels_differ_only_on_near_ties(jm, got, images, max_differ):
    """Stated tolerance of cosine labels: at most ``max_differ`` differ from
    JAX's, each where JAX's top-2 float32 margin is below 1e-6."""
    want = np.asarray(jm.predict(jnp.asarray(images)))
    differ = np.nonzero(got != want)[0]
    assert len(differ) <= max_differ, differ
    if len(differ):
        margins = _jax_top2_margins(jm, images[differ])
        assert (margins < 1e-6).all(), margins
    return want


def test_cosine_labels_differ_only_on_float32_near_ties(train_hdc_pair):
    """Cosine ``predict`` scores in float32, where the two packages round
    differently: at most 2 of 1024 labels differ, and each only where
    JAX's top-2 float32 margin is below 1e-6."""
    ds, jm, tm = train_hdc_pair
    got = tm.predict(ds.test_images).numpy()
    _assert_labels_differ_only_on_near_ties(jm, got, ds.test_images, max_differ=2)


def test_packed_words_equal_jax_at_full_width(jax_side):
    """The uhd smoke configuration (D = 8192, fit 512 then partial_fit
    512): row sums pass 2**24, where JAX's float32 centering mean is
    inexact, and still every bit of the packed class words agrees."""
    ds = jload("synth_mnist", n_train=1024, n_test=1)
    x, y = ds.train_images, ds.train_labels
    jcfg, tcfg = _configs(d=8192)
    j0 = JModel.create(jcfg).fit(x[:512], y[:512])
    t0 = HDCModel.create(tcfg, device="cpu").fit(x[:512], y[:512])
    for jm, tm in ((j0, t0), (j0.partial_fit(x[512:], y[512:]), t0.partial_fit(x[512:], y[512:]))):
        np.testing.assert_array_equal(tm.class_sums.numpy(), np.asarray(jm.class_sums))
        assert np.abs(tm.class_sums.numpy().astype(np.int64).sum(-1)).max() > 2**24
        np.testing.assert_array_equal(tm.pack().numpy().view(np.uint32), np.asarray(jm.pack()))


# ---------------------------------------------------------------------------
# ItemMemory
# ---------------------------------------------------------------------------


def test_item_memory_equals_jax(jax_side):
    d = 300
    rng = np.random.default_rng(4)
    hvs = np.where(rng.random((40, d)) < 0.5, 1, -1).astype(np.int8)
    mine, ref = ItemMemory(d, device="cpu"), JItemMemory(d, impl="jnp")
    np.testing.assert_array_equal(mine.add(hvs[:20]), ref.add(hvs[:20]))
    pos = ref.add(hvs[20:30])
    np.testing.assert_array_equal(pos, np.arange(20, 30))
    mine_words = tunary.pack_hypervector(torch.from_numpy(hvs[20:30]))  # int32 bit patterns
    np.testing.assert_array_equal(mine.add_packed(mine_words), pos)
    packed = rng.integers(0, 2**32, (5, tunary.n_words(d)), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= (1 << (d % 32)) - 1  # pad bits zero, as the packers leave them
    np.testing.assert_array_equal(mine.add_packed(packed), ref.add_packed(packed))
    for store in (mine, ref):
        store.delete([3, 0, 21])
        store.delete(-1)
    assert len(mine) == len(ref) == 31 and mine.nbytes == ref.nbytes
    np.testing.assert_array_equal(mine._rows.view(np.uint32), ref._rows)
    queries = [hvs[30:40], hvs[5], packed[:3]]
    for q, k in zip(queries, (1, 7, 31)):
        gi, gd = mine.search(q, k)
        wi, wd = ref.search(q, k)
        assert gi.dtype == gd.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
    gi, gd = mine.search(packed[:2], 1)
    assert (gd[:, 0] == 0).all()
    # the same errors as the JAX package
    for store in (mine, ref):
        with pytest.raises(ValueError, match="k must be in"):
            store.search(hvs[:1], 0)
        with pytest.raises(ValueError, match="expected hypervectors of d=300"):
            store.add(hvs[:2, :10])
        with pytest.raises(ValueError, match="words per row"):
            store.add_packed(packed[:, :3])
        with pytest.raises(IndexError, match="out of range"):
            store.delete([31])
        with pytest.raises(ValueError, match="queries must be"):
            store.search(hvs[:2, :10], 1)
    with pytest.raises(ValueError, match="d must be positive"):
        ItemMemory(0, device="cpu")


def test_item_memory_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ItemMemory(64)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_train_hdc_cli_on_the_cpu_matches_jax_accuracy(jax_side, tmp_path):
    n_train, n_test, d = 512, 128, 256
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_hdc", "--device", "cpu",
         "--d", str(d), "--n-train", str(n_train), "--n-test", str(n_test),
         "--batch-size", "200", "--save-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "round-trip ok: True" in out.stdout
    acc = float(re.search(r"accuracy (\d\.\d+)", out.stdout).group(1))
    ds = jload("synth_mnist", n_train=n_train, n_test=n_test)
    jm = JModel.create(_configs(d=d)[0]).fit_batches(
        (ds.train_images[i : i + 200], ds.train_labels[i : i + 200]) for i in range(0, n_train, 200)
    )
    loaded = HDCModel.load(tmp_path, device="cpu")
    np.testing.assert_array_equal(loaded.class_sums.numpy(), np.asarray(jm.class_sums))
    # equal class sums; cosine labels within the near-tie tolerance (one
    # image of these 128, number 103, sits 1.2e-7 from a tie in JAX)
    got = loaded.predict(ds.test_images).numpy()
    assert acc == round(float((got == ds.test_labels).mean()), 4)
    want = _assert_labels_differ_only_on_near_ties(jm, got, ds.test_images, max_differ=1)
    n_near = int((_jax_top2_margins(jm, ds.test_images) < 1e-6).sum())
    assert abs(int((got == ds.test_labels).sum()) - int((want == ds.test_labels).sum())) <= n_near


# ---------------------------------------------------------------------------
# On the card: both table kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,d,levels",
    [(64, 784, 8192, 16), (37, 100, 1000, 16), (37, 100, 1008, 16), (33, 113, 257, 256),
     (33, 113, 260, 256), (5, 49, 300, 2), (70, 40, 1003, 2**16), (1, 1, 1, 16),
     (64, 784, 2048, 256), (64, 1, 2048, 16), (64, 7, 2040, 16), (65, 7, 8192, 256)],
)
def test_cuda_encode_bundle_equals_plain(cuda, b, h, d, levels):
    """Rows whose pitch (D * itemsize bytes) is a multiple of 16 bytes take
    16-byte loads (ragged last block included), int8 rows of 8 or 4 bytes loads
    of that width, the others element loads; H of 1 and 7 runs one H split, H =
    784 up to 16; an int32 table (levels 256 and above) takes the int32 compares
    and dynamic shared memory."""
    x, _, table = _table_inputs(b + h, b, h, d, levels)
    xt, st = torch.from_numpy(x).to(cuda), torch.from_numpy(table).to(cuda)
    got = tops.encode_bundle(xt, st)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.encode_bundle(xt, st))
    # a contiguous table whose base is one element off a 16-byte boundary takes
    # element loads
    off = torch.empty(h * d + 1, dtype=st.dtype, device=cuda)[1:].view(h, d)
    off.copy_(st)
    assert torch.equal(tops.encode_bundle(xt, off), got)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 2040, 2044, 8192])
@pytest.mark.parametrize("b", [1, 63, 64, 65, 1024])
def test_cuda_encode_bundle_d_shards_equal_plain(cuda, b, d):
    # the serving and D-shard widths (2040: 8-byte loads, 2044: 4-byte loads), one and
    # two 64-row tiles, and train_hdc's evaluate batch (B = 1024, one H split)
    x, _, table = _table_inputs(b * 5 + d, b, 784, d, 16)
    xt, st = torch.from_numpy(x).to(cuda), torch.from_numpy(table).to(cuda)
    tops.reset_launches()
    got = tops.encode_bundle(xt, st)
    torch.cuda.synchronize()
    assert list(tops.LAUNCH_SHAPES["encode_bundle"]) == [f"B={b} H=784 D={d} table=int8"]
    assert torch.equal(got, tref.encode_bundle(xt, st))


def _negative_table_case(seed: int, b: int, h: int, d: int):
    """An int8 table with entries in [-128, 127] in its first h // 2 rows and in
    [0, 127] after them (so some chunks take the byte lanes and some the int32
    compares), and x outside [0, 128], the int32 extremes included."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 128, (h, d)).astype(np.int8)
    table[: h // 2] = rng.integers(-128, 128, (h // 2, d))
    table[0, : d // 2] = -128
    x = rng.integers(-300, 300, (b, h)).astype(np.int32)
    x[::3, ::4] = rng.integers(-2**31, 2**31, x[::3, ::4].shape)
    x[1::5, 1 % h] = 2**31 - 1
    x[2::5, 2 % h] = -2**31
    return x, table


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,d", [(64, 784, 2040), (65, 784, 8192), (64, 784, 2044), (9, 100, 257), (1, 7, 33)]
)
def test_cuda_encode_bundle_negative_entries_equal_plain(cuda, b, h, d):
    x, table = _negative_table_case(b + h + d, b, h, d)
    xt, st = torch.from_numpy(x).to(cuda), torch.from_numpy(table).to(cuda)
    got = tops.encode_bundle(xt, st)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.encode_bundle(xt, st))
    # the same entries as int32: compared as the same integers
    assert torch.equal(tops.encode_bundle(xt, st.to(torch.int32)), got)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,d,c,levels",
    [(512, 784, 8192, 10, 16), (2048, 784, 8192, 10, 16), (37, 100, 1000, 10, 16),
     (65, 100, 1008, 10, 16), (300, 49, 300, 200, 256), (129, 33, 77, 3, 2)],
)
def test_cuda_fit_bundle_equals_plain(cuda, b, h, d, c, levels):
    x, labels, table = _table_inputs(b + d, b, h, d, levels, n_classes=c)
    labels[::7] = -1  # out-of-range labels: never written, never summed
    labels[3::11] = c
    xt, st, lt = (torch.from_numpy(a).to(cuda) for a in (x, table, labels))
    got = tops.fit_bundle(xt, st, lt, c)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.fit_bundle(xt, st, lt, c))


@pytest.mark.parametrize(
    "dtype,h,c,want",
    [(torch.int8, 784, 10, "histogram"), (torch.int8, 113, 48, "histogram"),
     (torch.int8, 784, 49, "direct"), (torch.int8, 784, 0, "direct"),
     (torch.int32, 784, 10, "direct"), (torch.int16, 49, 2, "direct"),
     (torch.int8, 2**16, 4, "histogram"), (torch.int8, 2**16 + 1, 4, "direct")],
)
def test_fit_table_path_chooses_from_dtype_and_shape(dtype, h, c, want):
    # int8 entries span at most 256 thresholds a row; a histogram block holds (4, 257, C
    # rounded up to 4) counts, and G = (H, 256, C rounded up to 4) int32 stays within 256 MiB
    assert tops.fit_table_path(dtype, h, c) == want


def _fit_by_histogram(x, tab, labels, n_classes):
    """Kernel 3's class-histogram form in plain torch: x[:, h] bucketed as
    clamp(x, lo_h - 1, hi_h) over its table row's [min, max], counted per
    class, suffix-summed to G[c, h, j] = #{b labelled c : x[b, h] >= lo_h + j},
    then sums[c, d] = sum_h (2 * G[c, h, S[h, d] - lo_h] - n_c)."""
    s = tab.to(torch.int64)
    lab = labels.to(torch.int64)
    keep = (lab >= 0) & (lab < n_classes)
    x, lab = x.to(torch.int64)[keep], lab[keep]
    h, d = s.shape
    lo, hi = s.min(1).values, s.max(1).values
    v = torch.minimum(torch.maximum(x, lo - 1), hi) - (lo - 1)  # buckets 0 .. hi - lo + 1
    counts = torch.zeros((n_classes, h, 258), dtype=torch.int64)
    counts.index_put_((lab[:, None].expand_as(v), torch.arange(h).expand_as(v), v),
                      torch.ones_like(v), accumulate=True)
    g = counts.flip(-1).cumsum(-1).flip(-1)[:, :, 1:]  # G[c, h, j]: buckets above j
    n_c = torch.bincount(lab, minlength=n_classes)
    picked = g.gather(2, (s - lo[:, None])[None].expand(n_classes, h, d))
    return (2 * picked.sum(1) - h * n_c[:, None]).to(torch.int32)


def _full_range_case(seed: int, b: int, h: int, d: int, n_classes: int):
    """An int8 table whose entries span [-128, 127] (a constant row, a row at
    each extreme), x outside every row's range, labels -1 and C."""
    rng = np.random.default_rng(seed)
    table = rng.integers(-128, 128, (h, d)).astype(np.int8)
    table[0] = 5
    table[1 % h, : d // 2] = -128
    table[2 % h, d // 3 :] = 127
    x = rng.integers(-300, 300, (b, h)).astype(np.int32)
    x[::3, ::4] = rng.integers(-2**31, 2**31, x[::3, ::4].shape)
    x[1::5, 1] = 2**31 - 1
    x[2::5, 2 % h] = -2**31
    labels = rng.integers(0, n_classes, b).astype(np.int32)
    labels[::7] = -1
    labels[3::11] = n_classes
    return x, labels, table


@pytest.mark.parametrize(
    "b,h,d,c", [(37, 100, 1000, 10), (33, 113, 257, 26), (65, 30, 130, 3), (1, 5, 33, 2),
                (300, 49, 300, 48)],
)
def test_histogram_identity_equals_plain_fit_bundle(b, h, d, c):
    x, labels, table = _full_range_case(b + h + d, b, h, d, c)
    args = (torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(labels), c)
    assert torch.equal(_fit_by_histogram(*args), tref.fit_bundle(*args))
    # a Sobol table (levels 16: thresholds in [0, 16)) takes the same identity
    x, labels, table = _table_inputs(b * 3 + h, b, h, d, 16, n_classes=c)
    args = (torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(labels), c)
    assert torch.equal(_fit_by_histogram(*args), tref.fit_bundle(*args))


# (B, H, D, C, full-range int8 entries): ragged B, H and D, C = 26 and 48, the D-shard
# batches of the (2, 4) mesh at 2048 and 2040 columns (rows not 16-byte aligned)
_FIT_TABLE_CASES = [
    (37, 100, 1000, 10, True), (33, 113, 257, 26, True), (65, 30, 130, 3, True),
    (1, 5, 33, 2, True), (300, 49, 300, 48, True), (256, 784, 2048, 10, False),
    (256, 784, 2040, 10, False), (256, 784, 2040, 10, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["histogram", "direct"])
@pytest.mark.parametrize("b,h,d,c,full", _FIT_TABLE_CASES)
def test_cuda_fit_bundle_both_paths_equal_plain(cuda, path, b, h, d, c, full):
    if full:
        x, labels, table = _full_range_case(b + h + d, b, h, d, c)
    else:
        x, labels, table = _table_inputs(b + d, b, h, d, 16, n_classes=c)
    if path == "direct":  # the same entries, wider: the compare-and-count kernel
        table = table.astype(np.int32)
    xt, st, lt = (torch.from_numpy(a).to(cuda) for a in (x, table, labels))
    assert tops.fit_table_path(st.dtype, h, c) == path
    tops.reset_launches()
    got = tops.fit_bundle(xt, st, lt, c)
    torch.cuda.synchronize()
    assert list(tops.LAUNCH_SHAPES["fit_bundle"]) == [
        f"B={b} H={h} C={c} D={d} table={table.dtype} path={path}"]
    assert torch.equal(got, tref.fit_bundle(xt, st, lt, c))


@pytest.mark.cuda
def test_cuda_uhd_model_and_item_memory_equal_the_cpu(cuda):
    ds = tload("synth_mnist", n_train=256, n_test=64)
    cfg = HDCConfig(n_features=784, n_classes=10, d=1000)
    cpu = HDCModel.create(cfg, device="cpu").fit(ds.train_images, ds.train_labels)
    tops.reset_launches()
    card = HDCModel.create(cfg, device=cuda).fit(ds.train_images, ds.train_labels)
    assert torch.equal(card.class_sums.cpu(), cpu.class_sums)
    got = thm.predict_packed(card, ds.test_images, card.pack())
    assert torch.equal(got.cpu(), thm.predict_packed(cpu, ds.test_images, cpu.pack()))
    assert tops.LAUNCHES["fit_bundle"] == 1 and tops.LAUNCHES["encode_bundle"] == 1
    mem_cpu, mem_card = ItemMemory(1000, device="cpu"), ItemMemory(1000, device=cuda)
    for mem in (mem_cpu, mem_card):
        mem.add(card.encode(ds.test_images).cpu())
        mem.delete([0, 5])
    q = cpu.encode(ds.train_images[:16])
    for a, b in zip(mem_card.search(q, 5), mem_cpu.search(q, 5)):
        np.testing.assert_array_equal(a, b)
