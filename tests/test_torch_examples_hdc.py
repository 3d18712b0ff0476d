"""The HDC examples of the port (``repro_torch.examples.{hdc_at_scale,
vector_search}``) against the JAX package's scripts, each run with
``--device cpu`` in a subprocess beside the JAX script under
``JAX_PLATFORMS=cpu``: the printed accuracies and labels are JAX's.
Cosine ``predict`` scores in float32, where the two packages round
differently, so the port's labels, recorded image by image, may differ
from JAX's only where JAX's model has a near-tie (a top-2 margin below
1e-6; ROADMAP §3).
``quickstart`` is in ``test_torch_examples_quickstart.py``."""

from __future__ import annotations

import pytest
from test_torch_examples_common import (
    accuracy,
    assert_labels_differ_only_on_near_ties,
    chip_label_constants,
    chip_smoke,
    jax_example_labels,
    run_both,
    run_both_recording_labels,
)


def test_hdc_at_scale_prints_jax_accuracy_and_round_trip(tmp_path):
    jax, port, labels = run_both_recording_labels("hdc_at_scale", tmp_path / "labels.npz")
    assert port[0] == jax[0] == "mesh: {'data': 1, 'model': 1}"
    truth, [(want, margins)] = jax_example_labels("hdc_at_scale")
    jax_accs = {line.split()[-1] for line in jax if ": accuracy" in line}
    (port_acc_line,) = [line for line in port if ": accuracy" in line]
    assert jax_accs == {f"{accuracy(want, truth):.4f}"}  # JAX's two backends agree
    got, restored = labels  # the fitted model's, then the restored checkpoint's
    assert port_acc_line.endswith(f"accuracy {accuracy(got, truth):.4f}")
    assert_labels_differ_only_on_near_ties(got, want, margins)
    assert (restored == got).all()
    round_trip = "checkpoint round-trip onto mesh: predictions identical = True"
    assert round_trip in jax and round_trip in port
    assert port[-1] == "  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hdc_mnist"
    # chip_smoke.py holds the card's labels to the same JAX labels
    assert chip_smoke().JAX_EXAMPLE_LABELS["hdc_at_scale"] == chip_label_constants(
        [(want, margins)])


def test_vector_search_prints_jax_labels_classes_and_distances():
    jax, port = run_both("vector_search")
    assert port == jax
    assert any("top-3 classes" in line for line in port) and len(port) == 14


@pytest.mark.parametrize("name", ["hdc_at_scale", "vector_search", "quickstart"])
def test_example_raises_without_a_card_unless_given_the_cpu(name, monkeypatch):
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
