"""The port's serving plane (``repro_torch.serving``: batcher, pool,
registry with hot reload; ``launch.serve_hdc``) against the JAX package.

The same seeded numpy data trains a model in each package; every label
the port serves, through whatever queue, replica or reload, equals the
JAX package's ``HDCModel.predict`` (``similarity="hamming"``) of the
model at the step that served it, and every search result equals the
JAX engine's.  All comparisons are exact.  The CPU tests set no
wall-clock bound, wait with timeouts and stop every drain thread in a
finalizer; the ``cuda``-marked tests hold the CUDA-graph replay of the
engines to their eager step on a card.
"""

from __future__ import annotations

import gc
import re
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import HDCConfig, HDCModel, encoding
from repro_torch.kernels import ops
from repro_torch.launch import serve_hdc as tserve
from repro_torch.obs.prometheus import parse_exposition, render_prometheus
from repro_torch.serving import (
    DeviceExecution,
    MicroBatcher,
    ModelRegistry,
    QueueFull,
    ReplicaPool,
    ServingEngine,
    ServingMetrics,
    ShardedExecution,
)

try:  # a machine with a card runs the cuda-marked tests alone, and may have no JAX
    import jax

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import HDCModel as JModel
    from repro.core.model import HDCConfig as JConfig
    from repro.launch import serve_hdc as jserve
    from repro.serving import ServingEngine as JEngine
    from repro.serving.metrics import ServingMetrics as JMetrics
except ModuleNotFoundError:
    jax = None

N_FEATURES, N_CLASSES = 24, 4
ENCODERS = ("uhd", "uhd_dynamic", "baseline")


@pytest.fixture(autouse=True)
def _jax_side(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs the JAX package")


@pytest.fixture
def stopped():
    """Register batchers, pools and registries; each is stopped without a
    drain when the test ends, whatever happened in it."""
    owned: list = []
    yield owned.append
    for obj in owned:
        if isinstance(obj, ModelRegistry):
            obj.shutdown(drain=False)
        else:
            obj.stop(drain=False)


def _kw(**over):
    kw = dict(n_features=N_FEATURES, n_classes=N_CLASSES, d=128, levels=16, similarity="hamming")
    kw.update(over)
    return kw


def _data(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (n, N_FEATURES)).astype(np.float32),
            rng.integers(0, N_CLASSES, (n,)).astype(np.int32))


def _queries(seed: int, n: int = 12) -> np.ndarray:
    return _data(1000 + seed, n)[0]


def _pair(seed: int = 0, n: int = 32, **over):
    """The same fit in both packages: (JAX model, port model on the CPU)."""
    x, y = _data(seed, n)
    jm = JModel.create(JConfig(**_kw(**over))).fit(x, y)
    tm = HDCModel.create(HDCConfig(**_kw(**over)), device="cpu").fit(x, y)
    np.testing.assert_array_equal(tm.class_sums.numpy(), np.asarray(jm.class_sums))
    return jm, tm


def _jlabels(jm, x) -> np.ndarray:
    return np.asarray(jm.predict(x))


def _engine(tm, batch_size: int = 8, **kw) -> ServingEngine:
    return ServingEngine(tm, batch_size=batch_size, device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    return _pair()


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------


def test_batcher_flush_partial_batches(pair):
    """13 requests through 8 slots: two batches, three padded slots,
    labels equal to JAX's predict."""
    jm, tm = pair
    batcher = MicroBatcher(_engine(tm))
    x = _queries(0, 13)
    futures = batcher.submit_many(x)
    assert batcher.queue_depth() == 13
    assert batcher.flush() == 13
    got = np.asarray([f.result(timeout=0) for f in futures])
    np.testing.assert_array_equal(got, _jlabels(jm, x))
    m = batcher.metrics
    assert m.n_batches == 2 and m.n_slots == 16 and m.n_padded == 3 and m.queue_depth == 0
    snap = m.snapshot()
    assert snap["n_requests"] == 13 and 0 < snap["batch_occupancy"] < 1 and snap["p50_ms"] >= 0


def test_batcher_threaded_stream(pair, stopped):
    jm, tm = pair
    batcher = MicroBatcher(_engine(tm, 4), max_delay_ms=1.0).start()
    stopped(batcher)
    batcher.start()  # idempotent
    x = _queries(1, 11)
    got = np.asarray([f.result(timeout=30) for f in [batcher.submit(img) for img in x]])
    batcher.stop()
    np.testing.assert_array_equal(got, _jlabels(jm, x))


@pytest.mark.parametrize("started", [True, False], ids=["thread", "no-thread"])
def test_batcher_stop_with_drain_serves_the_queue(pair, stopped, started):
    jm, tm = pair
    batcher = MicroBatcher(_engine(tm, 4))
    stopped(batcher)
    if started:
        batcher.start()
    x = _queries(2, 9)
    futures = batcher.submit_many(x)
    batcher.stop(drain=True)
    assert all(f.done() for f in futures)
    np.testing.assert_array_equal([f.result(timeout=0) for f in futures], _jlabels(jm, x))


def test_batcher_stop_without_drain_rejects(pair):
    _, tm = pair
    batcher = MicroBatcher(_engine(tm, 4))  # never started: queue sits
    x = _queries(3, 3)
    futures = batcher.submit_many(x)
    batcher.stop(drain=False)
    for f in futures:
        with pytest.raises(RuntimeError, match="server stopped"):
            f.result(timeout=0)
    assert batcher.metrics.snapshot()["queue_depth"] == 0  # no phantom backlog
    with pytest.raises(RuntimeError, match="batcher is stopped"):
        batcher.submit(x[0])


def test_batcher_submit_validates_shape(pair):
    batcher = MicroBatcher(_engine(pair[1]))
    with pytest.raises(ValueError, match=r"one \(H,\) image"):
        batcher.submit(np.zeros((2, N_FEATURES), np.float32))
    with pytest.raises(ValueError, match=r"\(n, H\) images"):
        batcher.submit_block(np.zeros(N_FEATURES, np.float32))


def test_batcher_restart_after_stop(pair, stopped):
    jm, tm = pair
    batcher = MicroBatcher(_engine(tm, 4), max_delay_ms=1.0).start()
    stopped(batcher)
    x = _queries(4, 3)
    first = [f.result(timeout=30) for f in batcher.submit_many(x)]
    batcher.stop()
    with pytest.raises(RuntimeError, match="batcher is stopped"):
        batcher.submit(x[0])
    batcher.start()  # reopen
    second = [f.result(timeout=30) for f in batcher.submit_many(x)]
    batcher.stop()
    assert first == second == _jlabels(jm, x).tolist()


def test_batcher_flush_concurrent_with_drain_thread(pair, stopped):
    """flush() while the drain thread is live: every future resolves once
    with JAX's label, whichever thread served it."""
    jm, tm = pair
    batcher = MicroBatcher(_engine(tm, 4), max_delay_ms=5.0).start()
    stopped(batcher)
    x = _queries(5, 37)
    stop_flushing = threading.Event()

    def flusher():
        while not stop_flushing.is_set():
            batcher.flush()

    flush_thread = threading.Thread(target=flusher)
    flush_thread.start()
    try:
        futures = [batcher.submit(img) for img in x]
        got = np.asarray([f.result(timeout=30) for f in futures])
    finally:
        stop_flushing.set()
        flush_thread.join(30)
    assert not flush_thread.is_alive()
    np.testing.assert_array_equal(got, _jlabels(jm, x))
    assert batcher.metrics.n_requests == len(x)


def test_batcher_concurrent_stops_are_safe(pair, stopped):
    batcher = MicroBatcher(_engine(pair[1], 4)).start()
    stopped(batcher)
    futures = batcher.submit_many(_queries(6, 5))
    threads = [threading.Thread(target=batcher.stop) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert batcher.queue_depth() == 0 and all(f.done() for f in futures)


def test_batcher_max_depth_sheds_loudly(pair):
    batcher = MicroBatcher(_engine(pair[1], 4), max_depth=2)  # not started: queue holds
    x = _queries(7, 3)
    futures = [batcher.submit(x[0]), batcher.submit(x[1])]
    with pytest.raises(QueueFull, match="max_depth"):
        batcher.submit(x[2])
    assert batcher.metrics.n_shed == 1 and batcher.queue_depth() == 2
    batcher.flush()
    assert all(isinstance(f.result(timeout=0), int) for f in futures)


def test_batcher_submit_block_all_or_nothing(pair):
    jm, tm = pair
    batcher = MicroBatcher(_engine(tm, 4), max_depth=4)
    x = _queries(8, 3)
    futures = batcher.submit_block(x)  # depth 3 <= 4: all admitted
    with pytest.raises(QueueFull, match="batch shed"):
        batcher.submit_block(x)  # 3 + 3 > 4: none admitted
    assert batcher.queue_depth() == 3 and batcher.metrics.n_shed == 3
    batcher.flush()
    np.testing.assert_array_equal([f.result(timeout=0) for f in futures], _jlabels(jm, x))
    batcher.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit_block(x)
    assert batcher.metrics.n_rejected == 3


def test_batcher_delivers_engine_errors(pair):
    engine = _engine(pair[1], 4)

    class Boom(Exception):
        pass

    def boom(images):
        raise Boom("device fell over")

    engine.predict = boom
    batcher = MicroBatcher(engine)
    futures = batcher.submit_many(_queries(9, 2))
    batcher.flush()
    for f in futures:
        with pytest.raises(Boom):
            f.result(timeout=0)
    assert batcher.metrics.n_errors == 2


def test_take_batch_is_block_granular(pair):
    batcher = MicroBatcher(_engine(pair[1], 4))  # never started: steps are manual
    q = _queries(10, 6)
    a = batcher.submit_block(q[:3])
    b = batcher.submit_block(q[3:])
    # 3 + 3 > 4 slots: the second block is not split to fill the batch
    assert batcher.step() == 3
    assert all(f.done() for f in a) and not any(f.done() for f in b)
    assert batcher.step() == 3 and all(f.done() for f in b)


def test_take_batch_splits_only_oversize_blocks(pair):
    batcher = MicroBatcher(_engine(pair[1], 4))
    futs = batcher.submit_block(_queries(11, 6))  # 6 > 4 slots
    assert batcher.step() == 4  # the unavoidable split at the front
    assert batcher.step() == 2
    assert all(f.done() for f in futs) and batcher.queue_depth() == 0


def test_predict_and_search_blocks_never_share_a_step(pair):
    """Blocks of different (op, k) are served by separate steps, each
    result equal to the JAX engine's predict or search."""
    jm, tm = pair
    batcher = MicroBatcher(_engine(tm, 8))
    q = _queries(12, 6)
    blocks = [batcher.submit_block(q[:2]), batcher.submit_search_block(q[2:4], 2),
              batcher.submit_search_block(q[4:], 3), batcher.submit_block(q[4:])]
    with pytest.raises(ValueError, match="k must be"):
        batcher.submit_search_block(q[:1], 0)
    assert [batcher.step() for _ in range(4)] == [2, 2, 2, 2]
    assert batcher.metrics.n_batches == 4
    jengine = JEngine(jm, batch_size=8)
    np.testing.assert_array_equal([f.result(timeout=0) for f in blocks[0]], _jlabels(jm, q[:2]))
    np.testing.assert_array_equal([f.result(timeout=0) for f in blocks[3]], _jlabels(jm, q[4:]))
    for block, x, k in ((blocks[1], q[2:4], 2), (blocks[2], q[4:], 3)):
        want_i, want_d = jengine.search(x, k)
        for f, wi, wd in zip(block, want_i, want_d):
            idx, dist = f.result(timeout=0)
            np.testing.assert_array_equal(idx, wi)
            np.testing.assert_array_equal(dist, wd)


def test_hold_keeps_the_drain_off_until_it_exits(pair, stopped):
    jm, tm = pair
    batcher = MicroBatcher(_engine(tm, 4), max_delay_ms=0.5).start()
    stopped(batcher)
    x = _queries(13, 6)
    with batcher.hold():
        futures = batcher.submit_many(x)
        time.sleep(0.05)  # the drain thread is awake and must not take them
        assert batcher.queue_depth() == 6 and not any(f.done() for f in futures)
    np.testing.assert_array_equal([f.result(timeout=30) for f in futures], _jlabels(jm, x))


def test_engine_on_the_cpu_runs_eagerly_and_describes_it(pair):
    jm, tm = pair
    engine = _engine(tm).warmup()
    desc = engine.describe()
    assert desc["graph"] is False and desc["graphs"] == [] and desc["n_replays"] == 0
    assert engine.stream is None and engine.staging.shape == (8, N_FEATURES)
    x = _queries(14, 8)
    with engine.staged() as rows:
        rows[:] = x
        np.testing.assert_array_equal(engine.predict(rows), _jlabels(jm, x))
    np.testing.assert_array_equal(engine.predict(x[:3]), _jlabels(jm, x[:3]))


# ---------------------------------------------------------------------------
# registry + hot reload
# ---------------------------------------------------------------------------


def test_registry_lifecycle(pair, tmp_path, stopped):
    jm, tm = pair
    tm.save(tmp_path / "a", step=0)
    reg = ModelRegistry()
    stopped(reg)
    batcher = reg.register_checkpoint("a", tmp_path / "a", batch_size=4, devices=["cpu"])
    assert reg.names() == ("a",) and reg.batcher("a") is batcher
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", reg.engine("a"))
    with pytest.raises(KeyError, match="unknown model"):
        reg.engine("nope")
    x = _queries(15, 1)
    fut = reg.submit("a", x[0])
    batcher.flush()
    assert fut.result(timeout=0) == int(_jlabels(jm, x)[0])
    assert reg.describe()["a"]["placement"] == "device"
    # the exact-merge state loads in the JAX package's ServingMetrics
    state = reg.metrics_state()["a"]["serving"]
    assert JMetrics.from_state(state).state() == state
    types, _, samples = parse_exposition(render_prometheus(reg))
    assert types["uhd_requests_total"] == "counter"
    assert [v for n, _, v in samples if n == "uhd_requests_total"] == [1.0]
    reg.stop_all()
    assert reg.names() == ()


@pytest.mark.parametrize("encoder", ENCODERS)
def test_jax_checkpoint_hot_reloads_to_a_port_step_with_requests_queued(encoder, tmp_path,
                                                                       stopped):
    """A JAX-written step 0 served by the port's registry; the port trains
    and publishes step 1; `hot_reload` swaps with requests queued; every
    label equals JAX's predict at the step that served it."""
    x, y = _data(20, 64)
    jm0 = JModel.create(JConfig(**_kw(encoder=encoder))).fit(x[:32], y[:32])
    jm1 = jm0.partial_fit(x[32:], y[32:])
    jm0.save(tmp_path / "ckpt", step=0)

    reg = ModelRegistry()
    stopped(reg)
    batcher = reg.register_checkpoint("m", tmp_path / "ckpt", batch_size=4, devices=["cpu"])
    assert reg.hot_reload("m") is None  # nothing newer yet
    q = _queries(21, 6)
    before = batcher.submit_many(q)
    batcher.flush()  # served at step 0
    queued = batcher.submit_many(q)  # queued, drain not started

    tm1 = reg.engine("m").model.partial_fit(x[32:], y[32:])
    np.testing.assert_array_equal(tm1.class_sums.numpy(), np.asarray(jm1.class_sums))
    tm1.save(tmp_path / "ckpt", step=1)
    assert reg.hot_reload("m") == 1
    assert reg.engine("m").step == 1 and reg.engine("m").model.n_examples == 64
    assert batcher.queue_depth() == 6  # nothing dropped
    batcher.flush()
    for futures, jm, step in ((before, jm0, 0), (queued, jm1, 1)):
        np.testing.assert_array_equal([f.result(timeout=0) for f in futures], _jlabels(jm, q))
        assert {f.trace.step for f in futures} == {step}
    assert batcher.metrics.n_reloads == 1
    # an explicit step pins an exact version (rollback)
    assert reg.hot_reload("m", step=0) == 0
    assert reg.engine("m").model.n_examples == 32


def test_hot_reload_table_checkpoint_to_dynamic_checkpoint(pair, tmp_path, stopped):
    jm, tm = pair
    tm.save(tmp_path / "ckpt", step=0)
    reg = ModelRegistry()
    stopped(reg)
    batcher = reg.register_checkpoint("m", tmp_path / "ckpt", batch_size=4, devices=["cpu"])
    q = _queries(22, 6)
    queued = batcher.submit_many(q)
    tm.convert("uhd_dynamic").save(tmp_path / "ckpt", step=1)
    assert reg.hot_reload("m") == 1
    assert reg.engine("m").model.cfg.encoder == "uhd_dynamic"
    batcher.flush()
    after = batcher.submit_many(q)
    batcher.flush()
    want = _jlabels(jm, q)
    np.testing.assert_array_equal([f.result(timeout=0) for f in queued], want)
    np.testing.assert_array_equal([f.result(timeout=0) for f in after], want)


def test_hot_reload_requires_checkpoint_source(pair, stopped):
    reg = ModelRegistry()
    stopped(reg)
    reg.register("mem", _engine(pair[1]))
    with pytest.raises(ValueError, match="hot reload needs a source"):
        reg.hot_reload("mem")


def test_checkpoint_poll_latest_equals_jax(pair, tmp_path):
    tm = pair[1]
    mine, theirs = CheckpointManager(tmp_path / "ckpt"), JManager(tmp_path / "ckpt")
    seen = []
    for step in (None, 3, 5):
        if step is not None:
            tm.save(tmp_path / "ckpt", step=step)
        for after in (None, 2, 3, 5, 9):
            assert mine.poll_latest(after) == theirs.poll_latest(after)
            seen.append(mine.poll_latest(after))
    assert seen[:5] == [None] * 5 and seen[5:7] == [3, 3] and seen[-5:] == [5, 5, 5, None, None]


def test_shutdown_stops_learners_then_watchers_then_batchers(pair, stopped):
    order = []

    class Stub:
        def __init__(self, kind):
            self.kind = kind

        def stop(self, **_):
            order.append(self.kind)

    reg = ModelRegistry()
    stopped(reg)
    batcher = reg.register("m", _engine(pair[1]))
    real_stop = batcher.stop
    batcher.stop = lambda **kw: (order.append("batcher"), real_stop(**kw))
    reg.attach_watcher("m", Stub("watcher"))
    reg.attach_learner("m", Stub("learner"))
    with pytest.raises(ValueError, match="already has a watcher"):
        reg.attach_watcher("m", Stub("watcher"))
    with pytest.raises(KeyError, match="unknown model"):
        reg.attach_learner("nope", Stub("learner"))
    reg.shutdown()
    reg.shutdown()  # idempotent
    assert order == ["learner", "watcher", "batcher"] and reg.names() == ()


# ---------------------------------------------------------------------------
# replica pool
# ---------------------------------------------------------------------------


def _mixed_pool_engines(tm, source=None, step=None):
    """Two CPU replicas and one replica sharded over 4 CPU shards."""
    executions = [DeviceExecution(device="cpu"), DeviceExecution(device="cpu"),
                  ShardedExecution(devices=["cpu"] * 4)]
    return [ServingEngine(tm, batch_size=8, step=step, source=source, execution=ex)
            for ex in executions]


def test_pool_of_device_and_sharded_replicas_serves_the_single_engines_results(pair, stopped):
    jm, tm = pair
    pool = ReplicaPool(_mixed_pool_engines(tm), max_delay_ms=0.5).start()
    stopped(pool)
    q = _queries(30, 24)
    single = _engine(tm)
    labels = [f.result(timeout=30) for f in pool.submit_many(q)]
    np.testing.assert_array_equal(labels, single.predict(q))
    np.testing.assert_array_equal(labels, _jlabels(jm, q))
    # a search block lands on one replica; each replica searches alike
    for _ in range(3):
        rows = [f.result(timeout=30) for f in pool.submit_search_block(q[:5], 3)]
        want_i, want_d = single.search(q[:5], 3)
        np.testing.assert_array_equal([r[0] for r in rows], want_i)
        np.testing.assert_array_equal([r[1] for r in rows], want_d)
    pool.stop()
    merged = pool.merged_metrics()
    assert merged.n_requests == 24 + 15 and pool.metrics.n_requests == 0
    assert sum(r.metrics.n_requests for r in pool.replicas) == 39
    desc = pool.describe()
    assert desc["placement"] == "pool" and desc["n_replicas"] == 3
    assert [r["placement"] for r in desc["replicas"]] == ["device", "device", "sharded"]


def test_pool_promotion_swaps_all_replicas_and_keeps_their_executions(pair, tmp_path, stopped):
    jm, tm = pair
    tm.save(tmp_path / "ckpt", step=0)
    engines = _mixed_pool_engines(tm, source=tmp_path / "ckpt", step=0)
    executions = [e.execution for e in engines]
    reg = ModelRegistry()
    stopped(reg)
    pool = reg.register_pool("m", engines, max_delay_ms=0.5)
    x, y = _data(31, 16)
    tm.partial_fit(x, y).save(tmp_path / "ckpt", step=2)
    queued = [pool.submit_block(_queries(32, 4)) for _ in range(3)]  # one a replica
    assert reg.hot_reload("m") == 2  # through ReplicaPool.reload_to
    assert [r.engine.step for r in pool.replicas] == [2, 2, 2]
    assert [r.engine.execution for r in pool.replicas] == executions
    assert pool.metrics.n_reloads == 1 and [r.metrics.n_reloads for r in pool.replicas] == [1] * 3
    with pytest.raises(TypeError, match="swap_engines"):
        pool.swap_engine(engines[0])
    with pytest.raises(ValueError, match="1 engines for 3 replicas"):
        pool.swap_engines(engines[:1])
    pool.start()
    want = _jlabels(jm.partial_fit(x, y), _queries(32, 4))
    for block in queued:
        np.testing.assert_array_equal([f.result(timeout=30) for f in block], want)
        assert {f.trace.step for f in block} == {2}


def test_pool_promotion_under_traffic_never_mixes_steps(pair, tmp_path, stopped):
    jm, tm = pair
    tm.save(tmp_path / "ckpt", step=0)
    reg = ModelRegistry()
    stopped(reg)
    pool = reg.register_checkpoint("m", tmp_path / "ckpt", replicas=2, batch_size=8,
                                   placement="device", devices=["cpu"], max_delay_ms=0.5,
                                   start=True)
    assert isinstance(pool, ReplicaPool)
    q = _queries(33, 4)
    blocks: list[list] = []
    stop = threading.Event()

    def traffic():
        while not stop.is_set() and len(blocks) < 400:
            blocks.append(pool.submit_block(q))
            time.sleep(0.001)

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        tm.save(tmp_path / "ckpt", step=1)
        assert reg.hot_reload("m") == 1  # promote mid-traffic
        for _ in range(4):  # guaranteed post-promotion traffic
            blocks.append(pool.submit_block(q))
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    want = _jlabels(jm, q).tolist()
    for block in blocks:
        assert [f.result(timeout=30) for f in block] == want
    steps = [{f.trace.step for f in block} for block in blocks]
    assert all(len(s) == 1 for s in steps)
    assert {1} <= {s.pop() for s in steps}
    assert all(r.engine.step == 1 for r in pool.replicas)


def test_pool_dispatch_and_admission(pair):
    tm = pair[1]
    pool = ReplicaPool([_engine(tm) for _ in range(2)], max_depth=8)  # not started
    q = _queries(34, 8)
    for img in q[:4]:
        pool.submit(img)
    assert [r.queue_depth() for r in pool.replicas] == [2, 2]  # ties round-robin
    pool.replicas[0].submit_block(q[:3])  # backlog replica 0 directly (not admitted)
    pool.submit(q[4])
    assert [r.queue_depth() for r in pool.replicas] == [5, 3]  # the idle one took it
    with pytest.raises(QueueFull, match="fleet queue depth"):
        pool.submit(q[5])
    assert pool.metrics.n_shed == 1 and all(r.metrics.n_shed == 0 for r in pool.replicas)
    pool.stop()  # drains synchronously
    with pytest.raises(RuntimeError, match="stopped"):
        pool.submit(q[5])
    assert pool.metrics.n_rejected == 1 and pool.queue_depth() == 0


def test_registry_metrics_state_of_a_pool_is_the_merged_state(pair, stopped):
    tm = pair[1]
    reg = ModelRegistry()
    stopped(reg)
    pool = reg.register_pool("p", [_engine(tm) for _ in range(2)])
    for f in pool.submit_many(_queries(35, 5)):
        pass
    for r in pool.replicas:
        r.flush()
    state = reg.metrics_state()["p"]["serving"]
    assert state == pool.merged_metrics().state()
    assert JMetrics.from_state(state).state() == ServingMetrics.from_state(state).state()
    text = render_prometheus(reg)
    assert {ls["replica"] for n, ls, _ in parse_exposition(text)[2]
            if n == "uhd_requests_total"} == {"pool", "0", "1"}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SMOKE_ARGS = ["--smoke", "--d", "256", "--n-train", "128", "--requests", "32", "--batch", "8"]


def _accuracy_line(out: str) -> str:
    return re.search(r"served accuracy over \d+ requests: [0-9.]+", out).group(0)


@pytest.mark.parametrize("encoder", ["uhd", "uhd_dynamic"])
def test_serve_hdc_smoke_serves_jax_launchers_accuracy(encoder, tmp_path, capsys):
    args = SMOKE_ARGS + ["--encoder", encoder]
    assert jserve.main(args + ["--ckpt", str(tmp_path / "jax")]) == 0
    want = _accuracy_line(capsys.readouterr().out)
    assert tserve.main(args + ["--device", "cpu", "--ckpt", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert _accuracy_line(out) == want
    assert "with 16 requests queued" in out and "reloads 1, errors 0" in out

    r = tserve.smoke(tserve.parser().parse_args(
        args + ["--device", "cpu", "--ckpt", str(tmp_path / "again")]))
    assert r.steps.tolist() == [0] * 16 + [1] * 16 and r.queued_at_reload == 16
    assert r.metrics["n_requests"] == 32 and r.metrics["n_reloads"] == 1
    assert r.engines[0].step == 0 and r.engines[1].step == 1
    stream = tserve.load_dataset("synth_mnist", n_train=128, n_test=32).test_images
    for engine, half in zip(r.engines, (slice(0, 16), slice(16, 32))):
        np.testing.assert_array_equal(r.labels[half], engine.predict(stream[half]))


def test_serve_hdc_serves_an_existing_checkpoint(pair, tmp_path, capsys):
    pair[1].save(tmp_path / "ckpt", step=4)
    assert tserve.main(["--ckpt", str(tmp_path / "ckpt"), "--device", "cpu",
                        "--requests", "20", "--batch", "8"]) == 0
    out = capsys.readouterr().out
    assert "'step': 4" in out and "[uhd] served 20 requests" in out


# ---------------------------------------------------------------------------
# on the card: the CUDA graphs of the engines
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _card_model(encoder: str, dev, d: int = 2048, seed: int = 40):
    x, y = _data(seed, 256)
    cfg = HDCConfig(**_kw(encoder=encoder, d=d, n_features=N_FEATURES))
    return HDCModel.create(cfg, device=dev).fit(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", [False, True], ids=["device", "4-shards"])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_cuda_graph_replay_equals_the_eager_step(cuda, encoder, sharded):
    model = _card_model(encoder, cuda)
    execution = ShardedExecution(devices=[cuda] * 4) if sharded else DeviceExecution(device=cuda)
    engine = ServingEngine(model, batch_size=16, execution=execution).warmup()
    assert engine.describe()["graph"] is True
    x = _queries(41, 16)
    ops.reset_launches()
    got = engine.predict(x)
    replayed = dict(ops.LAUNCHES)
    eager = engine.execution.predict(engine.model, engine.class_words, x).cpu().numpy()
    np.testing.assert_array_equal(got, eager)
    assert sum(replayed.values()) >= 2 and engine.n_replays == 1  # a replay counts its kernels
    for k in (1, 3):
        idx, dist = engine.search(x, k)
        e_idx, e_dist = engine.execution.search(engine.model, engine.class_words, x, k)
        np.testing.assert_array_equal(idx, e_idx.cpu().numpy())
        np.testing.assert_array_equal(dist, e_dist.cpu().numpy())
    assert [(g["op"], g["k"]) for g in engine.describe()["graphs"]] == [
        ("predict", 0), ("search", 1), ("search", 3)]
    np.testing.assert_array_equal(engine.predict(x[:5]), eager[:5])  # another shape: eager
    assert engine.n_replays == 3


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["uhd", "baseline"])
def test_cuda_hot_reload_while_a_thread_streams_requests(cuda, encoder, tmp_path, stopped):
    model = _card_model(encoder, cuda)
    model.save(tmp_path / "ckpt", step=0)
    x, y = _data(42, 64)
    model.partial_fit(x, y).save(tmp_path / "ckpt", step=1)
    reg = ModelRegistry()
    stopped(reg)
    batcher = reg.register_checkpoint("m", tmp_path / "ckpt", step=0, batch_size=16,
                                      devices=[cuda], start=True)
    q = _queries(43, 8)
    blocks: list[list] = []
    stop = threading.Event()

    def traffic():
        while not stop.is_set():
            blocks.append(batcher.submit_block(q))

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        while len(blocks) < 20:
            time.sleep(0.001)
        assert reg.hot_reload("m") == 1  # captures on this thread while the drain serves
        n = len(blocks)
        while len(blocks) < n + 20:
            time.sleep(0.001)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    engines = {s: ServingEngine.from_checkpoint(tmp_path / "ckpt", step=s, batch_size=16,
                                                device=cuda) for s in (0, 1)}
    want = {s: e.predict(q).tolist() for s, e in engines.items()}
    steps = set()
    for block in blocks:
        labels = [f.result(timeout=30) for f in block]
        (step,) = {f.trace.step for f in block}  # each block on one step
        assert labels == want[step]
        steps.add(step)
    assert steps == {0, 1}
    assert batcher.metrics.n_errors == 0 and batcher.metrics.n_reloads == 1
    assert batcher.metrics.n_requests == 8 * len(blocks)  # nothing dropped


@pytest.mark.cuda
def test_cuda_old_engine_and_its_graph_are_freed_after_reload(cuda, tmp_path, stopped):
    model = _card_model("baseline", cuda)
    for step in range(4):
        model.save(tmp_path / "ckpt", step=step, keep_n=4)
    del model
    gc.collect()
    reg = ModelRegistry()
    stopped(reg)
    reg.register_checkpoint("m", tmp_path / "ckpt", step=0, batch_size=16, devices=[cuda])
    reg.engine("m").search(_queries(44, 16), 2)  # a second graph in the engine's pool
    refs, allocated, reserved = [], [], []
    for step in (1, 2, 3):
        old = reg.engine("m")
        refs.append((weakref.ref(old), weakref.ref(old._graphs[("predict", 0)].graph),
                     [weakref.ref(o) for g in old._graphs.values() for o in g.operands]))
        assert refs[-1][2]  # the graph holds the baseline's cached O'
        del old
        assert reg.hot_reload("m", step=step) == step
        reg.engine("m").search(_queries(44, 16), 2)
        gc.collect()
        torch.cuda.current_stream(cuda).synchronize()
        torch.cuda.empty_cache()
        allocated.append(torch.cuda.memory_allocated(cuda))
        reserved.append(torch.cuda.memory_reserved(cuda))
    for engine_ref, graph_ref, operand_refs in refs:
        assert engine_ref() is None and graph_ref() is None
        assert all(o() is None for o in operand_refs)
    assert allocated[0] == allocated[1] == allocated[2]  # one engine's worth, not three
    assert reserved[2] <= reserved[0]
    assert encoding.BASELINE_OPERANDS.builds > 0


@pytest.mark.cuda
def test_cuda_capture_that_cannot_succeed_raises(cuda):
    engine = ServingEngine(_card_model("uhd", cuda), batch_size=16, device=cuda)
    step = engine._step

    def host_sync(op, images):  # a host read inside the step: no graph can hold it
        out = step(op, images)
        out[0].sum().item()
        return out

    engine._step = host_sync
    with pytest.raises(Exception, match="capturing|capture"):
        engine.warmup()
    assert engine.describe()["graphs"] == []
    fresh = ServingEngine(_card_model("uhd", cuda), batch_size=16, device=cuda).warmup()
    x = _queries(45, 16)
    np.testing.assert_array_equal(
        fresh.predict(x), fresh.execution.predict(fresh.model, fresh.class_words, x).cpu().numpy())
