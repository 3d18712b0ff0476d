"""``repro_torch.examples.quickstart --device cpu`` against the JAX
package's ``examples/quickstart.py`` (``JAX_PLATFORMS=cpu``), the two run
side by side in subprocesses: the same dataset line, the accuracies
each package's labels give, and the port's labels image by image equal
to JAX's, apart from JAX's float32 cosine near-ties (see
``test_torch_examples_hdc.py``)."""

from __future__ import annotations

from test_torch_examples_common import (
    accuracy,
    assert_labels_differ_only_on_near_ties,
    chip_label_constants,
    chip_smoke,
    jax_example_labels,
    run_both_recording_labels,
)


def _printed(uhd: float, base: list[float]) -> list[str]:
    return [f"uHD  @ i=1 (one pass):      accuracy = {uhd:.4f}",
            f"baseline over 3 draws:      avg = {sum(base)/len(base):.4f}  "
            f"(min {min(base):.4f}, max {max(base):.4f})"]


def test_quickstart_prints_jax_accuracies(tmp_path):
    jax, port, labels = run_both_recording_labels("quickstart", tmp_path / "labels.npz")
    assert len(port) == len(jax) == 4
    assert port[0] == jax[0]  # the dataset line
    truth, refs = jax_example_labels("quickstart")
    assert len(labels) == len(refs) == 4  # uHD, then the baseline's three draws
    # each script prints the accuracies of the labels held here
    for lines, labs in ((jax, [r[0] for r in refs]), (port, labels)):
        accs = [accuracy(x, truth) for x in labs]
        assert lines[1:3] == _printed(accs[0], accs[1:])
    for got, (want, margins) in zip(labels, refs):
        assert_labels_differ_only_on_near_ties(got, want, margins)
    assert port[3] == jax[3] == "uHD >= baseline average: True"
    # chip_smoke.py holds the card's labels to the same JAX labels
    assert chip_smoke().JAX_EXAMPLE_LABELS["quickstart"] == chip_label_constants(refs)
