"""uHD at CIFAR-100's shape: 3,072 colour features, 100 classes.

On the CPU (D = 256, blocks of at most 64): the port's ``fit_batches``,
``pack_queries`` and ``predict`` against the JAX package's and the
benchmark's plain reference past 1,110 features
(``bench/reference/wide.py``), bit for bit; the Sobol direction numbers
past dimension 1,110 (primitive polynomials of degrees 14 and 15) against
the JAX package's; the CIFAR-100 binary reader on a small file in that
format; the synthetic sets, unchanged; ``train_hdc --dataset cifar100``;
the set-up's spans ``sobol.directions`` and ``model.fit``.  On a card
(``cuda``): the engine's captured predict at the configuration's shape
against ``kernels/ref.py``.

JAX is imported optionally: a machine with a card runs the ``cuda`` test
alone, and may have no JAX.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import HDCConfig, HDCModel, encoding, sobol, unary
from repro_torch.core.hdc_model import _centered, predict_packed
from repro_torch.data import images as timages
from repro_torch.kernels import ops, ref
from repro_torch.launch import train_hdc
from repro_torch.obs import profiler
from repro_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the benchmark's plain reference, bench.reference

from bench.reference import wide  # noqa: E402

try:  # a machine with a card runs the cuda-marked test alone, and may have no JAX
    import jax

    from repro.core import HDCModel as JModel
    from repro.core import sobol as jsobol
    from repro.core.model import HDCConfig as JConfig
    from repro.data import images as jimages
except ModuleNotFoundError:
    jax = None

H, C, D = 3072, 100, 256
HDC = dict(n_features=H, n_classes=C, d=D, levels=16, encoder="uhd_dynamic", seed=0,
           sobol_skip=1, max_intensity=255.0)


@pytest.fixture(autouse=True)
def _jax_side(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs the JAX package")


def _data(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (n, H)).astype(np.float32),
            rng.integers(0, C, (n,)).astype(np.int32))


@pytest.fixture(scope="module")
def fitted():
    """The same two blocks of 64 fit in both packages, and 48 queries."""
    x, y = _data(0, 128)
    blocks = [(x[:64], y[:64]), (x[64:], y[64:])]
    cfg = dict(HDC, similarity="hamming")
    tm = HDCModel.create(HDCConfig(**cfg), device="cpu").fit_batches(blocks)
    jm = JModel.create(JConfig(**cfg)).fit_batches(blocks)
    return x, y, tm, jm, _data(1, 48)[0]


def test_fit_batches_pack_and_predict_equal_jax(fitted):
    x, y, tm, jm, q = fitted
    np.testing.assert_array_equal(tm.class_sums.numpy(), np.asarray(jm.class_sums))
    assert tm.n_seen == 128
    hv = tm.encode(q)
    np.testing.assert_array_equal(hv.numpy(), np.asarray(jm.encode(q)))
    np.testing.assert_array_equal(tm.pack_queries(hv).numpy().view(np.uint32),
                                  np.asarray(jm.pack_queries(jm.encode(q))).view(np.uint32))
    np.testing.assert_array_equal(tm.predict(q).numpy(), np.asarray(jm.predict(q)))


def test_fit_batches_pack_and_predict_equal_the_reference(fitted):
    x, y, tm, _, q = fitted
    r = wide.Reference(HDC)
    sums = r.class_sums(torch.from_numpy(x), torch.from_numpy(y), block=48)
    np.testing.assert_array_equal(sums.numpy(), tm.class_sums.numpy())
    hv = tm.encode(q)
    np.testing.assert_array_equal(r.encode(torch.from_numpy(q), block=20).numpy(), hv.numpy())
    np.testing.assert_array_equal(r.centred_bits(hv).numpy(),
                                  unary.unpack_bits(tm.pack_queries(hv), D).numpy())
    labels = r.labels(torch.from_numpy(q), sums).numpy()
    np.testing.assert_array_equal(labels, predict_packed(tm, q, tm.pack()).numpy())
    np.testing.assert_array_equal(labels, tm.predict(q).numpy())


def test_sobol_direction_numbers_past_dimension_1110_equal_jax():
    got, want = sobol.direction_matrix(H, 0), jsobol.direction_matrix(H, 0)
    np.testing.assert_array_equal(got, want)
    assert len(sobol.primitive_polynomials(H - 1)) == H - 1
    assert sobol.primitive_polynomials(H - 1)[-1].bit_length() - 1 == 15  # degree 15
    np.testing.assert_array_equal(sobol.quantized_direction_matrix(H, 16, seed=0)[1110:],
                                  jsobol.quantized_direction_matrix(H, 16, seed=0)[1110:])
    np.testing.assert_array_equal(wide.direction_integers(H, 0), got)


def _cifar_rows(rng, n: int) -> np.ndarray:
    rows = rng.integers(0, 256, (n, 3074), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 20, n)  # coarse label
    rows[:, 1] = rng.integers(0, 100, n)  # fine label
    return rows


def test_cifar100_binary_reader(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    folder = tmp_path / "cifar-100-binary"
    folder.mkdir()
    train, test = _cifar_rows(rng, 7), _cifar_rows(rng, 3)
    train.tofile(folder / "train.bin")
    test.tofile(folder / "test.bin")
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    ds = timages.load_dataset("cifar100")
    assert (ds.name, ds.synthetic, ds.n_classes, ds.image_shape) == ("cifar100", False, 100,
                                                                     (3, 32, 32))
    assert ds.n_features == 3072 and ds.train_images.dtype == np.float32
    np.testing.assert_array_equal(ds.train_labels, train[:, 1].astype(np.int32))  # the fine label
    np.testing.assert_array_equal(ds.test_labels, test[:, 1].astype(np.int32))
    # channel-major rows: pixel (i, j) of channel k is byte 2 + 1024 k + 32 i + j
    red_row3 = ds.test_images[2].reshape(3, 32, 32)[0, 3]
    np.testing.assert_array_equal(red_row3, test[2, 2 + 96:2 + 128])
    np.testing.assert_array_equal(ds.train_images[4].reshape(3, 32, 32)[2, 31, 31], train[4, -1])
    (folder / "test.bin").write_bytes(test.tobytes()[:-1])
    with pytest.raises(ValueError, match="3,074-byte rows"):
        timages.load_dataset("cifar100")


def test_synthetic_sets_are_unchanged_and_cifar100_falls_back(tmp_path, monkeypatch):
    assert timages.ALL_SYNTHETIC == jimages.ALL_SYNTHETIC
    assert "synth_cifar100" not in timages.ALL_SYNTHETIC
    for name in timages.ALL_SYNTHETIC:
        a, b = timages.make_synthetic(name, 24, 8, 2), jimages.make_synthetic(name, 24, 8, 2)
        for f in ("train_images", "train_labels", "test_images", "test_labels"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=name)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))  # no files there
    ds = timages.load_dataset("cifar100", n_train=40, n_test=10, seed=1)
    assert (ds.name, ds.synthetic, ds.image_shape) == ("synth_cifar100", True, (3, 32, 32))
    assert ds.train_images.shape == (40, 3072) and ds.test_images.shape == (10, 3072)
    assert ds.train_labels.min() >= 0 and ds.train_labels.max() < 100
    assert 0 <= ds.train_images.min() and ds.train_images.max() <= 255
    again = timages.load_dataset("synth_cifar100", n_train=40, n_test=10, seed=1)
    np.testing.assert_array_equal(ds.train_images, again.train_images)


def test_train_hdc_cifar100_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    argv = ["--dataset", "cifar100", "--device", "cpu", "--d", "256", "--n-train", "128",
            "--n-test", "32", "--encoder", "uhd_dynamic", "--batch-size", "64",
            "--save-dir", str(tmp_path / "ckpt")]
    assert train_hdc.main(argv) == 0
    out = capsys.readouterr().out
    assert "dataset synth_cifar100 (synthetic): 128 train / 32 test, 100 classes" in out
    assert "round-trip ok: True" in out


def test_setup_spans_are_recorded_and_in_the_capture_trace(tmp_path):
    cfg = HDCConfig(n_features=24, n_classes=3, d=64, encoder="uhd_dynamic")
    x, y = np.full((8, 24), 200.0, np.float32), np.arange(8) % 3

    def setup():
        HDCModel.create(cfg, device="cpu").fit_batches([(x, y), (x, y)])

    profiler.record_spans()
    setup()
    spans = profiler.take_spans()
    assert [s.name for s in spans if s.depth == 0] == ["sobol.directions", "model.fit",
                                                      "model.fit"]
    assert {s.name for s in spans if s.depth == 1} == {"model.copy_in", "model.quantize"}

    started = threading.Event()
    capture = threading.Thread(target=lambda: (started.set(),
                                               profiler.profile_capture(str(tmp_path), 1500)))
    capture.start()
    started.wait(10)
    deadline = time.monotonic() + 10
    while not profiler._recording and time.monotonic() < deadline:
        time.sleep(0.01)
    setup()
    capture.join(30)
    assert not capture.is_alive()
    (trace,) = tmp_path.glob("trace_*.json")
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "repro_torch.span"]
    assert names.count("sobol.directions") == 1 and names.count("model.fit") == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_captured_predict_at_100_classes_equals_the_plain_versions(cuda):
    """The configuration's shape (H = 3,072, C = 100, D = 8,192): the fit on
    the direct path, the engine's graph with kernel 5's tensor path in it."""
    d = 8192
    cfg = HDCConfig(n_features=H, n_classes=C, d=d, levels=16, encoder="uhd_dynamic")
    g = torch.Generator(device=cuda).manual_seed(33)
    x = torch.rand((2048 + 300, H), generator=g, device=cuda) * 255
    y = torch.randint(0, C, (x.shape[0],), generator=g, device=cuda).to(torch.int32)
    ops.reset_launches()
    model = HDCModel.create(cfg, device=cuda).fit_batches([(x[:2048], y[:2048]),
                                                           (x[2048:], y[2048:])])
    assert set(ops.LAUNCH_SHAPES["fit_bundle_dynamic"]) == {
        f"B={b} H={H} C={C} D={d} dir=uint8 path=direct" for b in (2048, 300)}
    want = sum(ref.fit_bundle_dynamic(encoding.quantize_images(x[i:j], 16, 255.0),
                                      model.direction, y[i:j], C, d)
               for i, j in ((0, 2048), (2048, x.shape[0])))
    assert torch.equal(model.class_sums, want)

    engine = ServingEngine(model, batch_size=256, device=cuda).warmup()
    assert engine.describe()["graph"] is True
    words = unary.pack_hypervector(_centered(cfg, model.class_hvs))
    assert torch.equal(engine.class_words, words)
    q = torch.rand((256, H), generator=g, device=cuda) * 255
    ops.reset_launches()
    with engine.staged() as buf:
        np.copyto(buf, q.cpu().numpy())
        got = engine.predict(buf)
    assert engine.n_replays == 1
    assert ops.LAUNCH_SHAPES["hamming_topk"] == {f"B=256 C={C} W={d // 32} k=1 path=tensor": 1}
    hv = ref.encode_bundle_dynamic(encoding.quantize_images(q, 16, 255.0), model.direction, d)
    labels = ref.hamming_topk(unary.pack_hypervector(_centered(cfg, hv)), words, d, 1)[0][:, 0]
    np.testing.assert_array_equal(got, labels.cpu().numpy())
