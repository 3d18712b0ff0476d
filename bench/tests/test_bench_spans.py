"""``bench/spans.py`` on the CPU: idle gaps named by the program's innermost
span, the split's sums on a hand-built stretch, the harness's summary
and readers unchanged by it, and a traced run of each cell at small
sizes that splits its steps."""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from bench import cells
from bench.spans import ProgramStretch, Split, self_times, span_ns, split, traced_run
from bench.tracing import OUTSIDE, Stretch
from repro_torch.core.hdc_model import HDCModel
from repro_torch.core.item_memory import ItemMemory
from repro_torch.core.model import HDCConfig
from repro_torch.obs import profiler
from repro_torch.obs.profiler import Span

MS = 1_000_000
CPU = torch.device("cpu")

#: one step of 10 ms: the harness's two spans, the program's four inside them
HARNESS = [("encode", 1 * MS, 5 * MS), ("store search", 5 * MS, 9 * MS)]
PROGRAM = [Span("model.copy_in", 7, 0, 1 * MS, 2 * MS), Span("model.encode", 7, 0, 2 * MS, 4 * MS),
           Span("store.scan", 7, 0, 5 * MS, 6 * MS), Span("store.wait", 7, 0, 6 * MS, 9 * MS)]
BUSY = [(2 * MS, 4 * MS), (6 * MS, 8.5 * MS)]
STEPS = [(0, 10 * MS)]


def test_a_gap_inside_a_program_span_is_named_harness_slash_program():
    s = split(PROGRAM, HARNESS, STEPS, BUSY, 0, 10 * MS)
    assert dict((k, round(v * 1e3, 9)) for k, v in s.idle_gaps) == {
        "encode/model.copy_in": 2.0, "store search/store.scan": 2.0, OUTSIDE: 1.5}
    assert s.idle_covered == {"encode": 1.0, "store search": 1.0, OUTSIDE: 0.0}
    assert s.wait_lag_us == 500.0  # store.wait ends 0.5 ms after the device's last interval
    shifted = [(a + MS, b + MS) for a, b in BUSY]  # the device's times 1 ms late
    assert split(PROGRAM, HARNESS, STEPS, shifted, 0, 10 * MS).wait_lag_us == -500.0


def test_self_times_take_each_child_from_its_parent_alone():
    spans = [Span("a", 1, 0, 0, 100), Span("b", 1, 1, 10, 40), Span("c", 1, 2, 15, 25),
             Span("d", 1, 1, 50, 60), Span("e", 2, 0, 20, 30), Span("f", 2, 1, 22, 23)]
    assert self_times(spans) == [60, 20, 10, 10, 9, 1]


def test_self_times_of_a_recorded_search_sum_to_its_outer_span():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (8, 24)).astype(np.float32)
    cfg = HDCConfig(n_features=24, n_classes=4, d=256, levels=16, encoder="uhd_dynamic",
                    similarity="hamming")
    model = HDCModel.create(cfg, device="cpu").fit(x, np.arange(8, dtype=np.int32) % 4)
    store = ItemMemory(256, device="cpu")
    store.add_packed(model.pack_queries(model.encode(x)))
    profiler.record_spans()
    try:
        with profiler.span("test.step"):
            store.search(model.pack_queries(model.encode(x)).view(torch.uint32), 3)
    finally:
        spans = sorted(profiler.take_spans(), key=lambda s: (s.t0_ns, s.depth))
    own, outer = self_times(spans), spans[0]
    assert outer.name == "test.step" and len(spans) == 9
    assert min(own) >= 0 and sum(own) == outer.t1_ns - outer.t0_ns


def test_a_ring_that_dropped_spans_gives_no_sums():
    assert split(PROGRAM, HARNESS, STEPS, BUSY, 0, 10 * MS, dropped=3) == Split(spans_dropped=3)
    assert split(PROGRAM, HARNESS, STEPS, BUSY, 0, 10 * MS).spans_dropped == 0


def test_the_split_sums_a_hand_built_stretch():
    s = split(PROGRAM, HARNESS, STEPS, BUSY, 0, 10 * MS)
    assert (s.host_path_ms, s.device_wait_ms, s.program_idle_ms) == (4.0, 3.0, 2.5)
    assert (s.harness_self_ms, s.block_ms) == (1.0, 10.0)
    assert s.spans["store.scan"] == {"n": 1.0, "ms": 1.0, "self_ms": 1.0, "idle_ms": 2.0}
    nested = PROGRAM + [Span("model.pack", 7, 1, 3 * MS, 3.5 * MS)]
    t = split(nested, HARNESS, STEPS, BUSY, 0, 10 * MS)
    assert (t.host_path_ms, t.spans["model.encode"]["self_ms"]) == (4.0, 1.5)


class _Trace:
    """A profiler that exports a given list of trace events."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _stretch(cls):
    """A stretch whose trace clock runs 1 s ahead of the host's, over 10 ms."""
    st = cls(CPU)
    st.t0, st.t1, st.call0, st.call1 = 0, 10 * MS, 0, 10 * MS
    st.marks = [0, 10 * MS]
    us = lambda ns: (ns + 1e9) / 1e3  # noqa: E731
    st.prof = _Trace(
        [{"name": "bench.clock.start", "ph": "X", "ts": us(0), "dur": 1},
         {"name": "bench.clock.stop", "ph": "X", "ts": us(10 * MS), "dur": 1}]
        + [{"name": "k", "cat": "kernel", "ph": "X", "ts": us(a), "dur": (b - a) / 1e3}
           for a, b in BUSY])
    st.program, st.dropped = PROGRAM, 0
    return st


def test_the_harness_summary_and_readers_are_unchanged_by_the_split(small_root):
    plain = _stretch(Stretch).reduce(HARNESS, STEPS, 0.001)
    ours = _stretch(ProgramStretch).reduce(HARNESS, STEPS, 0.001)
    assert dataclasses.asdict(plain) == {k: v for k, v in dataclasses.asdict(ours).items()
                                         if k != "split"}
    assert ours.split.program_idle_ms == 2.5
    for name in ("step_mfu.query", "block_p95_ms", "kernel_roofline.query",
                 "device_idle_share.query"):
        read = cells.metric_reader(small_root, name)
        assert read({"summary": plain}) == read({"summary": ours})


@pytest.mark.parametrize("workload,names", [
    ("uhd_dynamic-mnist-d8192.classify",
     {"model.copy_in", "model.quantize", "model.encode", "model.pack", "engine.copy_out"}),
    ("uhd-mnist-d8192.search_1m",
     {"model.copy_in", "model.quantize", "model.encode", "model.pack", "store.copy_in",
      "store.rows", "store.scan", "store.wait"})])
def test_a_traced_run_splits_each_cell(small_root, workload, names):
    """On the CPU the device never runs: the stretch is one idle gap, and
    every step's program spans are idle time."""
    out = traced_run(cells.load_cell(small_root, workload), 11, 0.4, CPU, time.monotonic())
    assert out["correct"], (out["checks"], out["errors"])
    s = out["summary"].split
    assert set(s.spans) == names
    assert s.host_path_ms > 0 and s.device_wait_ms >= 0 and s.program_idle_ms > 0
    assert s.host_path_ms + s.device_wait_ms + s.harness_self_ms <= s.block_ms


def test_span_costs_are_measured_off_and_on():
    ns = span_ns(1000)
    assert set(ns) == {"off", "on"} and min(ns.values()) > 0
