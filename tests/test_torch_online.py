"""The port's online learner (``repro_torch.online``: buffer, learner;
``launch.serve_online``) against the JAX package's.

* The buffer takes the JAX copy's accept and shed decisions and drains
  the same blocks for one seeded put/drain sequence.
* The port learner's published class sums equal the JAX learner's and
  offline ``partial_fit``'s, bit for bit, under two chunkings; a step it
  publishes loads in ``repro``'s ``HDCModel.load`` and predicts JAX's
  labels.
* Shutdown stops the learner, then the watcher, then the batcher; bad
  feedback answers the JAX server's 400, 429 and 503 bodies.
* ``HDCModel._fit_sums`` checks numpy labels on the host before the copy,
  with the JAX package's error text.
* ``serve_online --smoke --device cpu`` passes with the JAX launcher's
  accuracies.

The ``cuda`` test trains on the learner's own stream on a card while a
thread streams requests over HTTP and the watcher promotes (capturing
graphs).  No test asserts a wall-clock bound; every wait polls with a
timeout and every server, learner and registry is stopped in a fixture.
"""

from __future__ import annotations

import json
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import HDCConfig, HDCModel, encoding
from repro_torch.launch import serve_online as tserve_online
from repro_torch.online import FeedbackBuffer, OnlineLearner
from repro_torch.serving import ModelRegistry, ServingEngine
from repro_torch.transport import HdcClient, HdcHttpServer, ReloadWatcher, protocol

try:  # a machine with a card runs the cuda-marked test alone, and may have no JAX
    import jax  # noqa: F401

    from repro.core import HDCConfig as JConfig
    from repro.core import HDCModel as JModel
    from repro.launch import serve_online as jserve_online
    from repro.online import FeedbackBuffer as JBuffer
    from repro.online import OnlineLearner as JLearner
    from repro.serving import ModelRegistry as JRegistry
    from repro.transport import HdcHttpServer as JServer
except ModuleNotFoundError:
    jax = None

N_FEATURES, N_CLASSES = 24, 4


@pytest.fixture(autouse=True)
def _jax_side(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs the JAX package")


def _kw(**over):
    kw = dict(n_features=N_FEATURES, n_classes=N_CLASSES, d=128, levels=16,
              similarity="hamming")
    kw.update(over)
    return kw


def _data(seed: int, n: int, n_features: int = N_FEATURES, n_classes: int = N_CLASSES):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (n, n_features)).astype(np.float32)
    y = rng.integers(0, n_classes, n).astype(np.int32)
    return x, y


def _wait(cond, timeout_s: float = 60.0, poll_s: float = 0.005) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met within the timeout")
        time.sleep(poll_s)


@pytest.fixture
def owned():
    """Servers, learners and registries of either package, stopped (servers
    first) when the test ends."""
    objs: list = []
    yield objs.append
    for obj in objs:
        if hasattr(obj, "_route"):
            obj.stop(drain=False, timeout_s=30.0)
    for obj in objs:
        if hasattr(obj, "shutdown"):
            obj.shutdown(drain=False)
        elif hasattr(obj, "buffer"):
            obj.stop(drain=False)


# ---------------------------------------------------------------------------
# the buffer
# ---------------------------------------------------------------------------


def _buffer_trace(cls):
    """One seeded put/drain sequence: every decision and drained block."""
    rng = np.random.default_rng(21)
    buf = cls(capacity=40)
    out = []
    for i in range(60):
        if rng.random() < 0.6:
            n = int(rng.integers(0, 17))
            x, y = _data(100 + i, n)
            out.append(("put", n, buf.put(x, y)))
        else:
            m = None if rng.random() < 0.2 else int(rng.integers(1, 30))
            got = buf.drain(max_examples=m, timeout=0.0)
            out.append(("drain", m, None if got is None
                        else (got[0].tobytes(), got[1].tobytes(), got[1].dtype.str)))
        out.append(("depth", buf.depth(), buf.snapshot()))
    buf.close()
    out.append(("closed", buf.closed, buf.drain(timeout=0.0) is not None))
    with pytest.raises(RuntimeError, match="closed") as e:
        buf.put(*_data(1, 1))
    out.append(("closed_put", str(e.value)))
    for bad in ((np.zeros((2, 3)), np.zeros(3)), (np.zeros(3), np.zeros(3))):
        with pytest.raises(ValueError) as e:
            buf.put(*bad)
        out.append(("bad", str(e.value)))
    return out


def test_buffer_decisions_and_drains_equal_jax():
    got, want = _buffer_trace(FeedbackBuffer), _buffer_trace(JBuffer)
    assert got == want
    assert any(step[0] == "put" and step[2] is False for step in got)  # it shed
    with pytest.raises(ValueError, match="capacity"):
        FeedbackBuffer(0)


def test_buffer_drain_preserves_arrival_order_and_splits():
    buf = FeedbackBuffer(capacity=100)
    xs = [_data(s, n) for s, n in ((1, 5), (2, 3), (3, 4))]
    for x, y in xs:
        assert buf.put(x, y)
    a = buf.drain(max_examples=7, timeout=0.0)
    b = buf.drain(timeout=0.0)
    assert np.array_equal(np.concatenate([a[0], b[0]]), np.concatenate([x for x, _ in xs]))
    assert np.array_equal(np.concatenate([a[1], b[1]]), np.concatenate([y for _, y in xs]))
    assert len(a[0]) == 7 and buf.depth() == 0 and buf.drain(timeout=0.0) is None


def test_buffer_close_wakes_a_parked_drain():
    buf = FeedbackBuffer(capacity=10)
    got = []
    t = threading.Thread(target=lambda: got.append(buf.drain(timeout=120.0)))
    t.start()
    buf.close()
    t.join(60.0)
    assert not t.is_alive() and got == [None]
    buf.reopen()
    assert not buf.closed and buf.put(*_data(2, 3))


# ---------------------------------------------------------------------------
# the learner against the JAX learner and offline partial_fit
# ---------------------------------------------------------------------------


def _jax_base(tmp_path, encoder="uhd", n=32):
    x, y = _data(3, n)
    base = JModel.create(JConfig(**_kw(encoder=encoder))).fit(x, y)
    base.save(tmp_path / "jax", step=0)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return base


def _learn(pkg, path, feed, *, chunk, train_batch, owned):
    reg_cls, learner_cls, extra = ((ModelRegistry, OnlineLearner, {"devices": ["cpu"]})
                                   if pkg == "port" else (JRegistry, JLearner, {}))
    registry = reg_cls()
    owned(registry)
    registry.register_checkpoint("m", path, batch_size=8, start=True, **extra)
    learner = learner_cls(registry, "m", train_batch=train_batch, publish_every_s=3600.0,
                          poll_interval_s=0.005)
    owned(learner)
    learner.start()
    x, y = feed
    for i in range(0, len(x), chunk):
        assert learner.submit(x[i : i + chunk], y[i : i + chunk])
    # the drain thread takes everything (training whole train_batch chunks,
    # keeping the tail pending); stop() trains the tail and publishes
    _wait(lambda: learner.snapshot()["buffered"] == 0)
    learner.stop()
    return learner


@pytest.mark.parametrize("encoder", ["uhd", "uhd_dynamic"])
@pytest.mark.parametrize("chunk,train_batch", [(7, 16), (16, 5)])
def test_learner_publishes_the_jax_learners_sums(tmp_path, owned, encoder, chunk, train_batch):
    base = _jax_base(tmp_path, encoder)
    feed = _data(4, 45)
    got = _learn("port", tmp_path / "port", feed, chunk=chunk, train_batch=train_batch,
                 owned=owned)
    want = _learn("jax", tmp_path / "jax", feed, chunk=chunk, train_batch=train_batch,
                  owned=owned)
    offline = np.asarray(base.partial_fit(*feed).class_sums)
    port_sums = HDCModel.load(tmp_path / "port", device="cpu").class_sums.numpy()
    jax_sums = np.asarray(JModel.load(tmp_path / "jax").class_sums)
    assert np.array_equal(port_sums, offline) and np.array_equal(jax_sums, offline)
    assert np.array_equal(got._model.class_sums.numpy(), offline)
    g, w = got.snapshot(), want.snapshot()
    for key in ("n_ingested", "n_shed", "n_trained", "n_published", "n_errors", "buffered",
                "lag_examples", "base_step", "step"):
        assert g[key] == w[key], key
    assert g.keys() == w.keys() and got.describe().keys() == want.describe().keys()
    assert g["stages"].keys() == w["stages"].keys() == {"ingest", "train", "publish"}
    assert g["stages"]["train"]["count"] == w["stages"]["train"]["count"]


def test_a_port_published_step_loads_in_the_jax_package(tmp_path, owned):
    base = _jax_base(tmp_path)
    feed = _data(5, 30)
    learner = _learn("port", tmp_path / "port", feed, chunk=9, train_batch=8, owned=owned)
    published = JModel.load(tmp_path / "port", step=learner.step)
    offline = base.partial_fit(*feed)
    q = _data(6, 40)[0]
    assert np.array_equal(np.asarray(published.class_sums), np.asarray(offline.class_sums))
    assert published.n_examples == offline.n_examples == 32 + 30
    assert np.array_equal(np.asarray(published.predict(q)), np.asarray(offline.predict(q)))
    port = HDCModel.load(tmp_path / "port", device="cpu")
    assert np.array_equal(port.predict(q).numpy(), np.asarray(offline.predict(q)))


def test_learner_trace_events_and_fleet_state(tmp_path, owned):
    _jax_base(tmp_path)
    learner = _learn("port", tmp_path / "port", _data(7, 20), chunk=10, train_batch=8,
                     owned=owned)
    registry = learner._registry
    (event,) = registry.traces.snapshot(kind="event")
    assert event["event"] == "publish" and event["step"] == 1
    assert set(event["spans"]) == {"ingest_ms", "train_ms", "publish_ms"}
    state = registry.metrics_state()["m"]
    assert state["online"]["n_trained"] == 20
    assert set(state["online_metrics"]["stages"]) == {"ingest", "train", "publish"}
    assert learner.metrics.latency.count == 1  # one publish cycle


def test_learner_needs_a_checkpoint_source_and_an_entry(owned):
    model = HDCModel.create(HDCConfig(**_kw()), device="cpu").fit(*_data(8, 16))
    registry = ModelRegistry()
    owned(registry)
    registry.register("m", ServingEngine(model, batch_size=8, device="cpu"))
    with pytest.raises(ValueError, match="checkpoint"):
        OnlineLearner(registry, "m").start()
    with pytest.raises(KeyError, match="unknown model"):
        OnlineLearner(ModelRegistry(), "ghost").start()


def test_learner_model_is_its_own(tmp_path, owned):
    """The learner trains a model it loaded, never the engine's: the
    served class sums stay the checkpoint's while the learner's move."""
    _jax_base(tmp_path)
    registry = ModelRegistry()
    owned(registry)
    registry.register_checkpoint("m", tmp_path / "port", batch_size=8, devices=["cpu"],
                                 start=True)
    before = registry.engine("m").model.class_sums.clone()
    learner = OnlineLearner(registry, "m", train_batch=4, publish_every_s=3600.0,
                            poll_interval_s=0.005).start()
    owned(learner)
    assert learner._model is not registry.engine("m").model
    assert learner._stream is None  # the CPU has no streams
    learner.submit(*_data(9, 8))
    _wait(lambda: learner.snapshot()["n_trained"] == 8)
    assert torch.equal(registry.engine("m").model.class_sums, before)
    assert not torch.equal(learner._model.class_sums, before)


def test_shutdown_stops_learner_then_watcher_then_batcher(tmp_path, owned):
    _jax_base(tmp_path)
    registry = ModelRegistry()
    owned(registry)
    batcher = registry.register_checkpoint("m", tmp_path / "port", batch_size=8,
                                           devices=["cpu"], start=True)
    learner = OnlineLearner(registry, "m", poll_interval_s=0.01).start()
    watcher = ReloadWatcher(registry, "m", interval_s=0.02).start()
    order = []
    for obj, tag in ((learner, "learner"), (watcher, "watcher"), (batcher, "batcher")):
        def spy(*a, _orig=obj.stop, _tag=tag, **kw):
            order.append(_tag)
            return _orig(*a, **kw)
        obj.stop = spy
    registry.shutdown()
    assert order == ["learner", "watcher", "batcher"]
    assert not learner.running() and not watcher.running()
    registry.shutdown()  # idempotent


# ---------------------------------------------------------------------------
# the feedback boundary: the JAX server's statuses and bodies
# ---------------------------------------------------------------------------


def _request(address, method, path, body=None, headers=None):
    import http.client

    conn = http.client.HTTPConnection(*address, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.headers.get("Content-Type"), resp.read()
    finally:
        conn.close()


def test_feedback_boundary_answers_equal_jax(tmp_path, owned):
    """400 (labels, shapes, bodies), 415, 405, 404, 429 with the buffer full
    and 503 once it is closed: the same bodies from either server, and
    nothing rejected is ingested."""
    _jax_base(tmp_path)
    x, _ = _data(10, 4)
    path = protocol.feedback_path("m")
    f32 = {"Content-Type": protocol.CT_F32}
    js = {"Content-Type": protocol.CT_JSON}
    script = [
        ("POST", protocol.feedback_path("nope"), protocol.encode_feedback(x, [0] * 4), f32),
        ("POST", path, protocol.encode_feedback(x, [N_CLASSES] * 4), f32),
        ("POST", path, json.dumps({"images": x.tolist(), "labels": [0, -1, 9, 2]}).encode(),
         js),
        ("POST", path, json.dumps({"images": [[1.0] * 7], "labels": [0]}).encode(), js),
        ("POST", path, b"\0" * 13, f32),
        ("POST", path, json.dumps({"images": x.tolist(), "labels": [0.5, 0, 0, 0]}).encode(),
         js),
        ("POST", path, b"not json", js),
        ("POST", path, b"x", {"Content-Type": "text/plain"}),
        ("GET", path, None, {}),
        ("POST", path, protocol.encode_feedback(x, [0, 1, 2, 3]), f32),  # 200, buffered 4
        ("POST", path, protocol.encode_feedback(x, [3, 2, 1, 0]), f32),  # 200, buffered 8
        ("POST", path, protocol.encode_feedback(x[:1], [1]), f32),  # 429: 8 + 1 > 8
    ]
    answers = {}
    for pkg, reg_cls, learner_cls, srv_cls, extra in (
        ("jax", JRegistry, JLearner, JServer, {}),
        ("port", ModelRegistry, OnlineLearner, HdcHttpServer, {"devices": ["cpu"]}),
    ):
        registry = reg_cls()
        owned(registry)
        registry.register_checkpoint("m", tmp_path / pkg, batch_size=8, start=True, **extra)
        # never started: the buffer fills deterministically
        learner = learner_cls(registry, "m", capacity=8)
        registry.attach_learner("m", learner)
        server = srv_cls(registry).start()
        owned(server)
        out = [_request(server.address, *req) for req in script]
        learner.buffer.close()  # a shutting-down learner answers 503, not 429
        out.append(_request(server.address, *script[-3]))
        out.append(learner.buffer.snapshot())
        answers[pkg] = out
    assert answers["port"] == answers["jax"]
    statuses = [a[0] for a in answers["port"][:-1]]
    assert statuses == [404, 400, 400, 400, 400, 400, 400, 415, 405, 200, 200, 429, 503]
    assert answers["port"][-1] == {"capacity": 8, "depth": 8, "n_ingested": 8, "n_shed": 1}


# ---------------------------------------------------------------------------
# HDCModel._fit_sums: labels checked on the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("labels", [[0, 1, 4, 2], [-1, 0, 0, 0], [7, 9, -3, 4]])
def test_out_of_range_labels_raise_the_jax_text_before_any_copy(labels, monkeypatch):
    x, _ = _data(11, 4)
    cfg = _kw()
    with pytest.raises(ValueError) as want:
        JModel.create(JConfig(**cfg)).partial_fit(x, np.asarray(labels, np.int32))
    seen = []
    check = encoding.validate_labels
    monkeypatch.setattr(encoding, "validate_labels",
                        lambda lab, n: (seen.append(type(lab)), check(lab, n))[1])
    model = HDCModel.create(HDCConfig(**cfg), device="cpu")
    for fit in (model.fit, model.partial_fit):
        with pytest.raises(ValueError) as got:
            fit(x, np.asarray(labels, np.int32))
        assert str(got.value) == str(want.value)
    assert seen == [np.ndarray, np.ndarray]  # the host array, not a device copy
    with pytest.raises(ValueError) as got:  # a list is checked as a host array too
        model.partial_fit(x, labels)
    assert str(got.value) == str(want.value) and seen[-1] is np.ndarray


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_serve_online_smoke_prints_the_jax_launchers_accuracies(capsys):
    args = ["--smoke", "--d", "256", "--n-base", "64", "--n-feedback", "192",
            "--requests", "64", "--train-batch", "64", "--feedback-chunk", "32",
            "--watch-interval", "0.02", "--publish-interval", "0.05"]
    assert jserve_online.main(args) == 0
    want = capsys.readouterr().out
    assert tserve_online.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def accuracies(out):
        return [ln.split(":")[1].split()[0] for ln in out.splitlines()
                if ln.startswith("held-out accuracy")]

    assert accuracies(got) == accuracies(want) and len(accuracies(got)) == 2
    assert "bit-identical to offline partial_fit" in got
    assert got.rstrip().endswith("smoke OK")


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["uhd", "uhd_dynamic"])
def test_learner_trains_on_its_stream_while_http_streams_and_the_watcher_captures(
        tmp_path, owned, card, encoder):
    """On the card: the learner trains on its own stream while a thread
    streams requests over HTTP and the watcher promotes each published step
    (capturing the new engine's CUDA graph).  The promoted sums equal
    offline ``partial_fit``, no capture or training error occurs, and every
    streamed label equals the eager predict of the model of the step that
    served it (read from the request's trace)."""
    n_features, n_classes = 784, 10
    cfg = HDCConfig(n_features=n_features, n_classes=n_classes, d=2048, levels=16,
                    encoder=encoder, similarity="hamming")
    base_x, base_y = _data(12, 256, n_features, n_classes)
    feed_x, feed_y = _data(13, 1024, n_features, n_classes)
    base = HDCModel.create(cfg, device=card).fit(base_x, base_y)
    base.save(tmp_path / "ckpt", step=0)
    registry = ModelRegistry(trace_capacity=1 << 18)  # every streamed slot's trace
    owned(registry)
    registry.register_checkpoint("m", tmp_path / "ckpt", batch_size=32, devices=[card],
                                 start=True)
    learner = OnlineLearner(registry, "m", train_batch=128, publish_every_s=0.05,
                            poll_interval_s=0.005, keep_n=0)  # every step stays loadable
    owned(learner)
    learner.start()
    assert isinstance(learner._stream, torch.cuda.Stream)
    assert learner._stream != torch.cuda.default_stream(card)
    watcher = ReloadWatcher(registry, "m", interval_s=0.02).start()
    server = HdcHttpServer(registry).start()
    owned(server)
    q = _data(14, 64, n_features, n_classes)[0]
    stop, served, errors = threading.Event(), [], []

    def stream():
        try:
            with HdcClient(*server.address, timeout_s=120.0) as client:
                while not stop.is_set() and len(served) < 4096:
                    labels = client.predict_batch("m", q[:32])
                    served.append((client.last_request_id, labels))
        except Exception as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=stream, daemon=True)
    t.start()
    try:
        with HdcClient(*server.address, timeout_s=120.0) as client:
            for i in range(0, len(feed_x), 96):
                client.feedback("m", feed_x[i : i + 96], feed_y[i : i + 96])
        _wait(lambda: registry.engine("m").model.n_examples == 256 + 1024, timeout_s=120.0)
    finally:
        stop.set()
        t.join(120.0)
    assert not errors, errors
    offline = base.partial_fit(feed_x, feed_y)
    assert torch.equal(registry.engine("m").model.class_sums.cpu(), offline.class_sums.cpu())
    assert watcher.n_errors == 0 and watcher.n_promotions >= 1, watcher.last_error
    assert learner.snapshot()["n_errors"] == 0, learner.last_error
    assert served
    step_of = {t["id"]: t["step"] for t in registry.traces.snapshot(kind="request")}
    by_step = {}
    for rid, labels in served:
        for i, label in enumerate(labels):
            s = step_of[f"{rid}/{i}"]
            if s not in by_step:
                model = HDCModel.load(tmp_path / "ckpt", step=s, device=card)
                by_step[s] = model.predict(q[:32]).cpu().numpy()
            assert label == by_step[s][i], (rid, i, s)
    engine = registry.engine("m")
    with HdcClient(*server.address, timeout_s=120.0) as client:  # a batch of 32: a replay
        labels = client.predict_batch("m", q[:32])
    assert engine.describe()["graph"] and engine.n_replays > 0
    assert np.array_equal(labels, offline.predict(q[:32]).cpu().numpy())
