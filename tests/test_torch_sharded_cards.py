"""The HDC paths on distinct cards, on a machine with several NVIDIA GPUs.

    python -m pytest -m cuda tests/test_torch_sharded_cards.py

Every test here needs a card; the ``cards`` fixture skips a case when
fewer than its 2 or 4 cards are visible (decided in the fixture, never at
import), so on a one-card machine only the one-card stream cases run.
Nothing here imports JAX: each distinct-card path is held **exactly**
against the same path on one card, which the CPU tests hold to JAX.  At
small size (24 features, 4 classes, D = 256 and 200, batches of 32):

* ``partial_fit_sharded`` on a (1, N) and a (2, N/2) mesh of the cards;
* ``ShardedExecution`` predict and search over the cards;
* a ``ServingEngine`` over the cards: eager (no graph), one stream a card;
* a pool of single-card replicas under a hot reload, each replica's graph
  captured on its own card;
* the engine's stream order: an engine built while each card's current
  stream is a side stream held back by ``torch.cuda._sleep`` still serves
  its first step right (it waited for its words), and a step does not
  queue behind work on the cards' default streams.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import HDCConfig, HDCModel, partial_fit_sharded
from repro_torch.launch.mesh import mesh_for
from repro_torch.serving import (
    DeviceExecution,
    ModelRegistry,
    ServingEngine,
    ShardedExecution,
)

pytestmark = pytest.mark.cuda

N_FEATURES, N_CLASSES = 24, 4
ENCODERS = ("uhd", "uhd_dynamic", "baseline")
SLEEP_CYCLES = 2**30  # about half a second of one SM's clock


def _need(n: int) -> list[torch.device]:
    if not torch.cuda.is_available():
        pytest.skip("needs NVIDIA GPUs (the CUDA kernels have no CPU mode)")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, {torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.fixture(params=[2, 4], ids=["2-cards", "4-cards"])
def cards(request) -> list[torch.device]:
    """cuda:0 .. cuda:N-1, N distinct cards."""
    return _need(request.param)


@pytest.fixture(params=[1, 2, 4], ids=["4-shards-of-1-card", "2-cards", "4-cards"])
def shard_devices(request) -> list[torch.device]:
    """The devices of a 4-shard (one card) or an N-card sharded engine."""
    devs = _need(request.param)
    return devs * 4 if len(devs) == 1 else devs


def _data(seed: int, n: int = 32):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (n, N_FEATURES)).astype(np.float32),
            rng.integers(0, N_CLASSES, (n,)).astype(np.int32))


def _cfg(encoder: str, d: int) -> HDCConfig:
    return HDCConfig(n_features=N_FEATURES, n_classes=N_CLASSES, d=d, levels=16,
                     encoder=encoder, similarity="hamming")


def _model(encoder: str, d: int, dev, seed: int = 0) -> HDCModel:
    model = HDCModel.create(_cfg(encoder, d), device=dev)
    for s in range(2):
        model = model.partial_fit(*_data(seed + s))
    return model


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        torch.cuda.synchronize(dev)


@pytest.mark.parametrize("layout", ["1xN", "2xN/2"])
@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_partial_fit_sharded_on_distinct_cards_equals_one_card(cards, encoder, d, layout):
    n = len(cards)
    mesh = mesh_for(n, n if layout == "1xN" else n // 2, devices=cards)
    sharded = HDCModel.create(_cfg(encoder, d), device=cards[0])
    for s in range(2):
        sharded = partial_fit_sharded(sharded, *_data(s), mesh=mesh)
    _sync(cards)
    assert {str(sh.device) for sh in sharded.shards} == {
        str(mesh.device_at({"model": j})) for j in range(mesh.shape["model"])}
    one = _model(encoder, d, cards[0])
    assert torch.equal(sharded.class_sums.cpu(), one.class_sums.cpu())
    assert sharded.n_examples == one.n_examples


@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_sharded_execution_on_distinct_cards_equals_device_execution(cards, encoder, d):
    model = _model(encoder, d, cards[0])
    x, _ = _data(7)
    ex, one = ShardedExecution(devices=cards), DeviceExecution(device=cards[0])
    placed = ex.place(model)
    assert [sh.device for sh in placed.shards] == cards
    words, one_words = ex.pack(placed), one.pack(model)
    assert [w.device for w in words] == cards
    assert torch.equal(ex.predict(placed, words, x).cpu(), one.predict(model, one_words, x).cpu())
    for k in (1, 3):
        got = ex.search(placed, words, x, k)
        want = one.search(model, one_words, x, k)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("encoder", ENCODERS)
def test_engine_over_distinct_cards_is_eager_and_equals_the_one_card_engine(cards, encoder):
    model = _model(encoder, 256, cards[0])
    engine = ServingEngine(model, batch_size=16,
                           execution=ShardedExecution(devices=cards)).warmup()
    one = ServingEngine(model, batch_size=16, device=cards[0]).warmup()
    desc = engine.describe()
    assert desc["graph"] is False and desc["execution"]["devices"] == [str(c) for c in cards]
    assert [s.device for s in engine.streams] == cards and engine.stream is engine.streams[0]
    x = _data(8, 16)[0]
    np.testing.assert_array_equal(engine.predict(x), one.predict(x))
    np.testing.assert_array_equal(engine.predict(x[:5]), one.predict(x[:5]))
    for k in (1, 3):
        for g, w in zip(engine.search(x, k), one.search(x, k)):
            np.testing.assert_array_equal(g, w)
    assert engine.n_replays == 0 and one.n_replays > 0


def test_pool_of_single_card_replicas_under_a_hot_reload(cards, tmp_path):
    model = _model("uhd", 256, cards[0])
    model.save(tmp_path / "ckpt", step=0)
    model.partial_fit(*_data(9)).save(tmp_path / "ckpt", step=1)
    reg = ModelRegistry()
    try:
        pool = reg.register_checkpoint("m", tmp_path / "ckpt", step=0, batch_size=16,
                                       replicas=len(cards), placement="device",
                                       devices=cards, start=True)
        q = _data(10, 8)[0]
        blocks: list[list] = []
        stop = threading.Event()

        def traffic():
            while not stop.is_set():
                blocks.append(pool.submit_block(q))
                time.sleep(0.0005)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        try:
            while len(blocks) < 20:
                time.sleep(0.001)
            assert reg.hot_reload("m") == 1  # captures each replica's graph on its card
            n = len(blocks)
            while len(blocks) < n + 20:
                time.sleep(0.001)
        finally:
            stop.set()
            t.join(30)
        assert not t.is_alive()
        replicas = [r.engine.describe() for r in pool.replicas]
        assert [d["execution"]["device"] for d in replicas] == [str(c) for c in cards]
        assert all(d["step"] == 1 and d["graph"] and d["graphs"] for d in replicas)
        want = {s: ServingEngine.from_checkpoint(tmp_path / "ckpt", step=s, batch_size=16,
                                                 device=cards[0]).predict(q).tolist()
                for s in (0, 1)}
        steps = set()
        for block in blocks:
            labels = [f.result(timeout=30) for f in block]
            (step,) = {f.trace.step for f in block}  # each block on one step
            assert labels == want[step]
            steps.add(step)
        assert steps == {0, 1}
        merged = pool.merged_metrics()
        assert merged.n_errors == 0 and pool.metrics.n_reloads == 1
        assert merged.n_requests == 8 * len(blocks)  # nothing dropped
    finally:
        reg.shutdown()


@pytest.mark.parametrize("encoder", ENCODERS)
def test_engine_waits_for_its_words_made_on_delayed_side_streams(shard_devices, encoder):
    cards = list(dict.fromkeys(shard_devices))
    # no row centring: it would sum the shards' row sums on the output card while
    # packing, so the output card's side stream would wait for the others' and
    # the host for it, which hides the order under test
    model = HDCModel.create(dataclasses.replace(_cfg(encoder, 256), pack_center="none"),
                            device=cards[0])
    for s in range(2):
        model = model.partial_fit(*_data(s))
    x = _data(11, 5)[0]
    want = ServingEngine(model, batch_size=16, device=cards[0]).predict(x)
    execution = ShardedExecution(devices=shard_devices)
    placed = execution.place(model)  # the shards in place before, on the default streams
    _sync(cards)
    delayed = cards[1:] or cards  # every card but the output card (one card: that card)
    with contextlib.ExitStack() as stack:
        for c in cards:
            side = torch.cuda.Stream(device=c)
            stack.enter_context(torch.cuda.stream(side))
            if c in delayed:
                # garbage where the words will be allocated (a cached block of the
                # side stream's small pool: a new device allocation after the delay
                # would serialise the card's work behind it), then the delay
                junk = torch.full((1 << 16,), -1, dtype=torch.int32, device=c)
                del junk
                torch.cuda._sleep(SLEEP_CYCLES)
        # each card's words are packed on its side stream, after its delay
        engine = ServingEngine(placed, batch_size=16, execution=execution)
    assert engine.model is placed
    got = engine.predict(x)  # at once, eager (5 rows): ordered only by the engine's waits
    _sync(cards)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [16, 5], ids=["static-shape", "eager"])
def test_a_step_does_not_queue_behind_the_default_streams(shard_devices, rows):
    cards = list(dict.fromkeys(shard_devices))
    model = _model("uhd", 256, cards[0])
    engine = ServingEngine(model, batch_size=16,
                           execution=ShardedExecution(devices=shard_devices)).warmup()
    x = _data(12, rows)[0]
    want = engine.predict(x)
    _sync(cards)
    t0 = time.perf_counter()
    for c in cards:
        with torch.cuda.stream(torch.cuda.default_stream(c)):
            torch.cuda._sleep(SLEEP_CYCLES)
    t1 = time.perf_counter()
    got = engine.predict(x)
    step_s = time.perf_counter() - t1
    _sync(cards)
    asleep_s = time.perf_counter() - t0
    np.testing.assert_array_equal(got, want)
    assert step_s < asleep_s / 4, (step_s, asleep_s)
