"""The ported slice end to end against the JAX package: train, pack,
predict, search, checkpoint in one package and load in the other.

The same config and synthetic data go through ``repro`` and
``repro_torch`` (on the CPU, the port's plain datapath).  Everything
compared is integer or sign bits, so every comparison is **exact
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

import jax.numpy as jnp
import torch

from repro.core import HDCConfig as JConfig
from repro.core import HDCModel as JModel
from repro.core import hdc_model as jhm
from repro.data import load_dataset as jload
from repro_torch import convert
from repro_torch.core import HDCConfig, HDCModel
from repro_torch.core import hdc_model as thm
from repro_torch.data import load_dataset as tload
from repro_torch.serving import ServingEngine

SRC = Path(__file__).resolve().parents[1] / "src"
N_TRAIN, N_TEST = 240, 48


@pytest.fixture(scope="module")
def data():
    ds = jload("synth_mnist", n_train=N_TRAIN, n_test=N_TEST)
    mine = tload("synth_mnist", n_train=N_TRAIN, n_test=N_TEST)
    for f in ("train_images", "train_labels", "test_images", "test_labels"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ds, f))
    return ds


def _configs(d: int, skip: int):
    kw = dict(n_features=784, n_classes=10, d=d, encoder="uhd_dynamic", sobol_skip=skip)
    return JConfig(**kw), HDCConfig(**kw)


@pytest.fixture(scope="module", params=[(256, 1), (1000, 5)], ids=["d256", "d1000-skip5"])
def trained(request, data):
    """Both packages: fit on the first half, partial_fit on the second."""
    d, skip = request.param
    jcfg, tcfg = _configs(d, skip)
    half = N_TRAIN // 2
    x, y = data.train_images, data.train_labels
    j0 = JModel.create(jcfg).fit(x[:half], y[:half])
    t0 = HDCModel.create(tcfg, device="cpu").fit(x[:half], y[:half])
    j1, t1 = j0.partial_fit(x[half:], y[half:]), t0.partial_fit(x[half:], y[half:])
    return dict(j=(j0, j1), t=(t0, t1))


def test_class_sums_equal_after_fit_and_partial_fit(trained):
    for jm, tm in zip(trained["j"], trained["t"]):
        np.testing.assert_array_equal(tm.class_sums.numpy(), np.asarray(jm.class_sums))
        assert tm.n_examples == jm.n_examples
    # partial_fit returned a new model; the step-0 model is unchanged
    assert trained["t"][0].n_examples == N_TRAIN // 2


def test_packed_words_equal(trained):
    for jm, tm in zip(trained["j"], trained["t"]):
        np.testing.assert_array_equal(tm.pack().numpy().view(np.uint32), np.asarray(jm.pack()))


def test_predict_packed_and_search_equal(trained, data):
    jm, tm = trained["j"][1], trained["t"][1]
    x = data.test_images
    want = np.asarray(jhm.predict_packed(jm, jnp.asarray(x), jm.pack()))
    got = thm.predict_packed(tm, x, tm.pack())
    np.testing.assert_array_equal(got.numpy(), want)
    ji, jd = jhm.search_packed(jm, jnp.asarray(x), jm.pack(), k=3)
    ti, td = thm.search_packed(tm, x, tm.pack(), k=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti[:, 0].numpy(), got.numpy())


def test_predict_hamming_equals_jax_and_packed_path(trained, data):
    jm, tm = trained["j"][1], trained["t"][1]
    jh = jm.replace(cfg=dataclasses.replace(jm.cfg, similarity="hamming"))
    th = HDCModel(
        dataclasses.replace(tm.cfg, similarity="hamming"), tm.codebooks, tm.class_sums,
        tm.n_seen, device="cpu",
    )
    got = th.predict(data.test_images).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.predict(jnp.asarray(data.test_images))))
    np.testing.assert_array_equal(got, thm.predict_packed(tm, data.test_images, tm.pack()).numpy())


def test_donated_partial_fit_and_fit_batches_equal_fit(trained, data):
    tm = trained["t"][1]
    half = N_TRAIN // 2
    x, y = data.train_images, data.train_labels
    streamed = tm.fit_batches([(x[:half], y[:half]), (x[half:], y[half:])])
    assert torch.equal(streamed.class_sums, tm.class_sums)
    model = tm.reset()
    assert model.partial_fit(x, y, donate=True) is model
    assert torch.equal(model.class_sums, tm.class_sums) and model.n_examples == N_TRAIN
    with pytest.raises(ValueError, match="labels must be in"):
        tm.fit(x[:3], np.asarray([0, 10, 1]))


def test_jax_checkpoint_loads_in_port_with_identical_labels(trained, data, tmp_path):
    jm = trained["j"][1]
    jm.save(tmp_path / "jax", step=3)
    tm = HDCModel.load(tmp_path / "jax", device="cpu")
    assert tm.cfg.d == jm.cfg.d and tm.cfg.sobol_skip == jm.cfg.sobol_skip
    assert tm.n_examples == jm.n_examples
    want = np.asarray(jhm.predict_packed(jm, jnp.asarray(data.test_images), jm.pack()))
    engine = ServingEngine.from_checkpoint(tmp_path / "jax", device="cpu", batch_size=8)
    np.testing.assert_array_equal(engine.predict(data.test_images), want)
    assert engine.step == 3


def test_port_checkpoint_loads_in_jax_with_identical_labels(trained, data, tmp_path):
    tm = trained["t"][1]
    tm.save(tmp_path / "torch", step=1)
    jm = JModel.load(tmp_path / "torch")
    assert jm.n_examples == tm.n_examples
    np.testing.assert_array_equal(np.asarray(jm.class_sums), tm.class_sums.numpy())
    want = thm.predict_packed(tm, data.test_images, tm.pack()).numpy()
    got = np.asarray(jhm.predict_packed(jm, jnp.asarray(data.test_images), jm.pack()))
    np.testing.assert_array_equal(got, want)


def _jax_checkpoint(trained, data, path, backend):
    """A JAX checkpoint whose manifest names `backend`, and its labels."""
    jm = trained["j"][1]
    jm = jm.replace(cfg=dataclasses.replace(jm.cfg, backend=backend))
    jm.save(path, step=2)
    return np.asarray(jhm.predict_packed(jm, jnp.asarray(data.test_images), jm.pack()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")
    return torch.device("cuda")


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_jax_checkpoint_of_either_backend_loads_on_the_cpu(trained, data, tmp_path, backend):
    want = _jax_checkpoint(trained, data, tmp_path, backend)
    engine = ServingEngine.from_checkpoint(tmp_path, device="cpu", batch_size=8)
    assert engine.model.cfg.backend == "auto" and engine.impl == "ref"
    np.testing.assert_array_equal(engine.predict(data.test_images), want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_cuda_jax_checkpoint_of_either_backend_loads_on_the_card(
    cuda, trained, data, tmp_path, backend
):
    want = _jax_checkpoint(trained, data, tmp_path, backend)
    engine = ServingEngine.from_checkpoint(tmp_path, device=cuda, batch_size=8)
    assert engine.model.cfg.backend == "auto" and engine.impl == "cuda"
    np.testing.assert_array_equal(engine.predict(data.test_images), want)
    # a port model trained with the plain backend on the CPU serves on the card
    tm = trained["t"][1]
    HDCModel(dataclasses.replace(tm.cfg, backend="ref"), tm.codebooks, tm.class_sums,
             tm.n_seen, device="cpu").save(tmp_path / "port", step=0)
    engine = ServingEngine.from_checkpoint(tmp_path / "port", device=cuda, batch_size=8)
    np.testing.assert_array_equal(engine.predict(data.test_images), want)


def test_model_from_jax_state_round_trips(trained):
    jm = trained["j"][1]
    cfg = dataclasses.asdict(jm.cfg)
    for k in ("use_kernels", "encode_impl"):
        cfg.pop(k)
    state = {
        "codebooks/direction": np.asarray(jm.codebooks["direction"]),
        "class_sums": np.asarray(jm.class_sums),
        "n_seen": np.asarray(jm.n_seen),
    }
    tm = convert.model_from_jax_state(cfg, state, device="cpu")
    np.testing.assert_array_equal(tm.class_sums.numpy(), state["class_sums"])
    cfg2, state2 = convert.jax_state_from_model(tm)
    assert cfg2 == cfg
    assert set(state2) == set(state)
    for k in state:
        assert state2[k].dtype == state[k].dtype
        np.testing.assert_array_equal(state2[k], state[k])
    big = convert.model_from_jax_state(
        cfg, dict(state, n_seen=np.asarray([1, 2**32 - 1], np.uint32)), device="cpu"
    )
    assert big.n_examples == 2**33 - 1


def test_serve_hdc_smoke_cli_exits_zero(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_hdc", "--smoke", "--device", "cpu",
         "--d", "256", "--n-train", "128", "--requests", "32", "--ckpt", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "smoke OK" in out.stdout and "packed-path parity" in out.stdout
