"""The counted work against the worked values, and the shares read from it."""

from __future__ import annotations

import math

import pytest

from conftest import ROOT

from bench import cells, counts, shares
from bench.tracing import Summary


def test_encode_of_1024_images():
    w = counts.encode(1024, 784, 8192, "uhd")
    assert w.ops == 13_153_337_344
    assert w.least_s == pytest.approx(6.65e-6, rel=2e-3)  # bound by the integer peak


def test_search_over_2_20_rows():
    w = counts.search(64, 784, 8192, 1 << 20, 8, "uhd")
    assert w.bytes - counts.encode(64, 784, 8192, "uhd").bytes - 8 * 64 * 8 == 1_073_741_824
    assert w.least_s == pytest.approx(0.32e-3, rel=0.01)  # bound by the store's bytes


def test_fit_job_of_60000_images():
    w = counts.fit(60_000, 784, 8192, 10, "uhd_dynamic")
    assert w.ops == 2 * (60_000 * 784 + 10 * 784 * 8192)
    assert w.bytes == pytest.approx(188.7e6, rel=1e-3)
    assert w.least_s == pytest.approx(56e-6, rel=0.01)


def test_step_work_reads_the_traffic():
    cell = cells.load_cell(ROOT, "uhd-mnist-d8192.search_1m")
    entry = cell.entry_class()(cell, 1, "cpu")
    assert entry.work() == counts.search(64, 784, 8192, 1 << 20, 8, "uhd")
    cell = cells.load_cell(ROOT, "uhd_dynamic-mnist-d8192.classify")
    assert cell.entry_class()(cell, 1, "cpu").work() == counts.classify(
        1024, 784, 8192, 10, "uhd_dynamic")


def _summary(**over) -> Summary:
    base = dict(window_s=2.0, busy_s=0.5, kernel_s=0.4, steps=100,
                least_s=100 * 6.65e-6, block_ms=[float(i) for i in range(1, 101)])
    return Summary(**{**base, **over})


def test_shares_are_percent_of_the_counted_least_time():
    s = _summary()
    assert shares.step_mfu(s) == pytest.approx(100 * s.least_s / 2.0)
    assert shares.kernel_roofline(s) == pytest.approx(100 * s.least_s / 0.4)
    assert shares.device_idle_share(s) == pytest.approx(75.0)
    assert shares.block_p95_ms(s) == 95.0


def test_shares_read_nothing_without_device_time_or_steps():
    assert shares.kernel_roofline(_summary(busy_s=0.0, kernel_s=0.0)) is None
    assert shares.step_mfu(_summary(steps=0, least_s=0.0)) is None
    assert shares.device_idle_share(None) is None
    assert shares.block_p95_ms(None) is None
    assert math.isclose(shares.device_idle_share(_summary(busy_s=1.5)), 25.0)
