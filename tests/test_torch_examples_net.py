"""The network examples of the port (``repro_torch.examples.{serve_http,
online_learning}``; ``scrape_metrics`` and ``fleet_dashboard`` are in
``test_torch_examples_obs.py``) against the JAX
package's scripts, each run with ``--device cpu`` in a subprocess beside
the JAX script under ``JAX_PLATFORMS=cpu``.  Served labels come from the
packed Hamming path (integer-exact), so the printed accuracies, codebook
sizes and counts are JAX's; lines of timing (latencies, ports, scrape
ages, the learner's publish count, request ids) are left out."""

from __future__ import annotations

import re

import pytest
from test_torch_examples_common import run_both


def test_serve_http_prints_jax_accuracy_and_promotion():
    jax, port = run_both("serve_http")
    assert [x for x in port if not x.startswith("serving on")] == \
        [x for x in jax if not x.startswith("serving on")]
    assert "served accuracy over 64 HTTP requests: 0.9062" in port


def _steady(lines: list[str]) -> list[str]:
    """online_learning's lines less what depends on timing: the port, the
    buffer depth of the last ack, the publish count and the promoted step."""
    out = []
    for line in lines:
        if line.startswith("serving on"):
            continue
        line = re.sub(r"'buffered': \d+", "'buffered': _", line)
        line = re.sub(r"published \d+", "published _", line)
        line = re.sub(r"promoted step \d+", "promoted step _", line)
        out.append(line)
    return out


def test_online_learning_prints_jax_accuracies_and_bit_identical_sums():
    jax, port = run_both("online_learning")
    assert _steady(port) == _steady(jax)
    assert any(x.endswith("bit-identical to offline partial_fit: True") for x in port)


@pytest.mark.parametrize("name", ["serve_http", "online_learning", "scrape_metrics",
                                  "fleet_dashboard"])
def test_example_raises_without_a_card_unless_given_the_cpu(name, monkeypatch):
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
