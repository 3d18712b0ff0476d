"""The port's host spans (``repro_torch.obs.profiler``): off by default
and then one shared context recording nothing, recorded in order and
nested by depth on each thread through the model's encode and pack, the
store's search, the engine's step (eager on the CPU, its CUDA graph on a
card), a wait for its lock and the batcher, bounded by a ring that
counts what it drops, and written into ``profile_capture``'s Chrome
trace on the trace's clock with that count.

This file imports no JAX: its ``cuda``-marked test runs on a card's
machine alone."""

from __future__ import annotations

import collections
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.hdc_model import HDCModel
from repro_torch.core.item_memory import ItemMemory
from repro_torch.core.model import HDCConfig
from repro_torch.obs import profiler
from repro_torch.serving import MicroBatcher, ServingEngine

N_FEATURES, N_CLASSES, D = 24, 4, 256
ENCODE = ["model.copy_in", "model.quantize", "model.encode"]


@pytest.fixture(autouse=True)
def _recording_off():
    """Every test starts and ends with recording off and the ring empty."""
    profiler.take_spans()
    yield
    profiler.take_spans()


def _data(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (n, N_FEATURES)).astype(np.float32),
            rng.integers(0, N_CLASSES, (n,)).astype(np.int32))


def _model(device="cpu", encoder: str = "uhd_dynamic") -> HDCModel:
    cfg = HDCConfig(n_features=N_FEATURES, n_classes=N_CLASSES, d=D, levels=16,
                    encoder=encoder, similarity="hamming")
    return HDCModel.create(cfg, device=device).fit(*_data(0, 64))


def _store(model: HDCModel) -> ItemMemory:
    store = ItemMemory(D, device=model.device)
    store.add_packed(model.pack_queries(model.encode(_data(1, 40)[0])))
    return store


def _steps(model: HDCModel) -> dict:
    """Each path: (a call of it, the spans it records in order as
    (name, depth) inside the test's own span at depth 0)."""
    x = _data(2, 8)[0]
    store = _store(model)
    engine = ServingEngine(model, batch_size=8, device=model.device)

    def staged():
        with engine.staged() as buf:
            buf[:] = x
            return engine.predict(buf)

    def batched():
        batcher = MicroBatcher(engine)
        futures = batcher.submit_many(x[:5])
        assert batcher.flush() == 5
        return [f.result(timeout=0) for f in futures]

    model_step = ENCODE + ["model.pack"]
    return {
        "encode_pack": (lambda: model.pack_queries(model.encode(x)),
                        [(n, 1) for n in model_step]),
        "search": (lambda: store.search(model.pack_queries(model.encode(x)).view(torch.uint32), 3),
                   [(n, 1) for n in model_step + ["store.copy_in", "store.rows", "store.scan",
                                                  "store.wait"]]),
        "engine_predict": (lambda: engine.predict(x),
                           [(n, 1) for n in model_step + ["engine.copy_out"]]),
        "engine_staged": (staged, [(n, 1) for n in model_step + ["engine.copy_out"]]),
        "batcher": (batched,
                    [("batcher.device", 1)] + [(n, 2) for n in model_step + ["engine.copy_out"]]),
    }


def _recorded(call) -> list:
    profiler.record_spans()
    try:
        with profiler.span("test.step"):
            out = call()
    finally:
        spans = profiler.take_spans()
    return out, spans


def test_spans_off_record_nothing_and_timed_block_still_times():
    model = _model()
    for call, _ in _steps(model).values():
        call()
    with profiler.span("off") as off:
        assert off is profiler.span("other")  # one shared context, nothing made
    x = np.arange(3)
    with profiler.timed_block("device") as tb:
        assert tb.sync(x) is x
    assert tb.label == "device" and tb.elapsed_s >= 0.0
    assert profiler.take_spans() == []


@pytest.mark.parametrize("path", ["encode_pack", "search", "engine_predict", "engine_staged",
                                  "batcher"])
def test_each_path_records_its_spans_in_order_and_nested(path):
    model = _model()
    call, want = _steps(model)[path]
    call()  # warm: the store's device rows are uploaded at the first search
    out, spans = _recorded(call)
    assert out is not None
    spans.sort(key=lambda s: (s.t0_ns, s.depth))
    assert [(s.name, s.depth) for s in spans] == [("test.step", 0)] + want
    assert len({s.thread for s in spans}) == 1 == profiler.spans_dropped + 1
    outer = spans[0]
    for s in spans:
        assert outer.t0_ns <= s.t0_ns <= s.t1_ns <= outer.t1_ns


class _SignallingLock:
    """The engine's lock, setting `blocking` as a thread starts a blocking
    acquire (inside its ``engine.lock`` span)."""

    def __init__(self):
        self.lock, self.blocking = threading.RLock(), threading.Event()

    def acquire(self, blocking: bool = True) -> bool:
        if blocking:
            self.blocking.set()
        return self.lock.acquire(blocking)

    def release(self) -> None:
        self.lock.release()


def test_a_wait_for_the_engine_lock_is_its_span_and_a_reentry_is_not():
    model = _model()
    engine = ServingEngine(model, batch_size=8, device=model.device)
    engine._lock = lock = _SignallingLock()
    x = _data(2, 8)[0]
    got = []

    def other():
        with profiler.span("other.step"):
            got.append(engine.predict(x))

    profiler.record_spans()
    try:
        with engine.staged() as buf:  # predict(buf) re-enters the lock: no wait
            buf[:] = x
            engine.predict(buf)
            assert not lock.blocking.is_set()
            t = threading.Thread(target=other)
            t.start()
            assert lock.blocking.wait(30)
        t.join(30)
    finally:
        spans = profiler.take_spans()
    assert not t.is_alive() and len(got) == 1
    np.testing.assert_array_equal(got[0], engine.predict(x))
    locks = [s for s in spans if s.name == "engine.lock"]
    assert [(s.thread, s.depth) for s in locks] == [(t.native_id, 1)]


def test_the_ring_drops_its_oldest_spans_past_capacity_and_counts_them():
    extra = 10
    profiler.record_spans()
    for i in range(profiler.SPAN_RING + extra):
        with profiler.span(f"s{i}"):
            pass
    spans = profiler.take_spans()
    assert len(spans) == profiler.SPAN_RING and profiler.spans_dropped == extra
    assert spans[0].name == f"s{extra}" and spans[-1].name == f"s{profiler.SPAN_RING + extra - 1}"
    profiler.record_spans()
    assert profiler.spans_dropped == 0
    with pytest.raises(RuntimeError, match="already"):
        profiler.record_spans()


def test_threads_keep_their_own_depths_and_no_entry_is_lost():
    """More threads than cores, a short switch interval: every span ends
    in the ring or in the drop count, and each thread's depths nest."""
    threads, per = 8, 10_000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        profiler.record_spans()

        def work():
            for _ in range(per // 2):
                with profiler.span("outer"):
                    with profiler.span("inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
        spans = profiler.take_spans()
    finally:
        sys.setswitchinterval(interval)
    assert len(spans) + profiler.spans_dropped == threads * per
    assert {(s.name, s.depth) for s in spans} == {("outer", 0), ("inner", 1)}


def _capture(tmp_path) -> tuple[list, threading.Thread]:
    """The events of a 200 ms capture while a thread searches a store, and
    that thread."""
    model = _model()
    store = _store(model)
    q = model.pack_queries(model.encode(_data(3, 8)[0])).view(torch.uint32)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            store.search(q, 3)

    t = threading.Thread(target=serve)
    t.start()
    try:
        profiler.profile_capture(str(tmp_path), 200.0)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    [path] = tmp_path.glob("trace_*.json")
    return json.loads(path.read_text())["traceEvents"], t


def _dropped(events) -> int:
    [e] = [e for e in events if e["name"] == "repro_torch.spans_dropped"]
    assert e["ph"] == "i" and e["ts"] == min(float(m["ts"]) for m in events
                                             if m["name"] == "repro_torch.clock.start")
    return e["args"]["count"]


def test_profile_capture_writes_the_spans_inside_its_window(tmp_path):
    events, t = _capture(tmp_path)
    marks = {e["name"]: float(e["ts"]) for e in events
             if str(e.get("name", "")).startswith("repro_torch.clock.")}
    lo, hi = marks["repro_torch.clock.start"], marks["repro_torch.clock.stop"]
    scans = [e for e in events if e.get("ph") == "X" and e["name"] == "store.scan"
             and e.get("cat") == "repro_torch.span"]
    assert scans and all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in scans)
    assert {e["tid"] for e in scans} == {t.native_id}
    assert _dropped(events) == profiler.spans_dropped
    assert profiler.take_spans() == []  # the capture left recording off


def test_profile_capture_reports_the_spans_its_ring_dropped(tmp_path, monkeypatch):
    ring = 16
    monkeypatch.setattr(profiler, "SPAN_RING", ring)
    monkeypatch.setattr(profiler, "_ring", collections.deque(maxlen=ring))
    events, _ = _capture(tmp_path)
    spans = [e for e in events if e.get("cat") == "repro_torch.span" and e["ph"] == "X"]
    assert len(spans) == ring and _dropped(events) == profiler.spans_dropped > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_graph_replay_records_replay_wait_and_copy_out(cuda):
    engine = ServingEngine(_model(cuda), batch_size=8, device=cuda).warmup()
    x = _data(2, 8)[0]
    want = engine.predict(x)
    for staged in (False, True):
        profiler.record_spans()
        try:
            if staged:
                with engine.staged() as buf:
                    buf[:] = x
                    got = engine.predict(buf)
            else:
                got = engine.predict(x)
        finally:
            spans = sorted(profiler.take_spans(), key=lambda s: s.t0_ns)
        np.testing.assert_array_equal(got, want)
        stage = [] if staged else ["engine.stage"]
        assert [(s.name, s.depth) for s in spans] == [
            (n, 0) for n in stage + ["engine.replay", "engine.wait", "engine.copy_out"]]
