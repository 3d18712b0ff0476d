"""The observability examples of the port (``repro_torch.examples.{
scrape_metrics, fleet_dashboard}``) against the JAX package's scripts,
each run with ``--device cpu`` in a subprocess beside the JAX script under
``JAX_PLATFORMS=cpu``: the same counters, Prometheus lines, trace and
target layout, frame counts and staleness; latencies, scrape ages, cycle
counts and request-id prefixes depend on timing and are left out."""

from __future__ import annotations

import re

from test_torch_examples_common import run_both


def test_scrape_metrics_prints_jax_counters_and_exposition():
    jax, port = run_both("scrape_metrics")

    def counted(lines):
        """The request count, the stages with requests counted by the time the
        device step resolved them (the write stage is counted after the
        client has its response), the Prometheus excerpt and the number of
        traces printed."""
        return ([x.split()[0] for x in lines if x.startswith("requests=")]
                + [x.split("p50=")[0] for x in lines
                   if x.strip().startswith("stage ") and "write" not in x]
                + [x for x in lines if x.strip().startswith("uhd_")]
                + [len([x for x in lines if x.strip().startswith("cli-")])])

    assert counted(port) == counted(jax)
    assert counted(port)[0] == "requests=96" and counted(port)[-1] == 3
    assert port[-1] == jax[-1] == "drained and shut down"


def test_fleet_dashboard_prints_jax_frames_and_staleness():
    jax, port = run_both("fleet_dashboard")

    def frames(lines):
        """Each frame's targets and marks, the final frame's stale count and
        merged traces, and the trace's attribution; the traces merged by an
        earlier frame depend on how many scrape cycles it waited for."""
        heads = [x for x in lines if x.startswith("-- fleet")]
        return ([x.split("scrapes=")[0] for x in lines if x.strip().startswith("[")]
                + [len(heads), re.sub(r"@ \d+ cycles", "@ _ cycles", heads[-1])]
                + [re.sub(r"cli-[0-9a-f]+-\d+", "_", x.split(", e2e")[0])
                   for x in lines if x.startswith("trace ")])

    assert frames(port) == frames(jax)
    assert "-- fleet @ _ cycles (1/2 stale, 1153 traces merged) --" in frames(port)
    assert port[-1] == jax[-1] == "done"
