"""Helpers of the example tests (``test_torch_examples_*.py``; this file
holds no test): run an
example of the JAX package (``examples/<name>.py`` under
``JAX_PLATFORMS=cpu``) and its port (``python -m
repro_torch.examples.<name> --device cpu``) side by side in subprocesses,
the port's with every label its models predict recorded, and hold those
labels image by image to the JAX package's: they may differ only where
JAX's top-2 cosine margin is a float32 near-tie (ROADMAP §3, "Cosine
near-ties")."""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: a JAX top-2 cosine margin below this is a near-tie: the packages'
#: float32 dot products round differently and may order the two classes
#: either way (the bound of test_torch_table's cosine near-tie test)
NEAR_TIE = 1e-6


def _env(threads: int | None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return env


def start(cmd: list[str], threads: int | None = None) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=ROOT, env=_env(threads), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: float = 300) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"{proc.args} exited {proc.returncode}:\n{err[-3000:]}"
    return out


def port_cmd(name: str, *args: str) -> list[str]:
    return [sys.executable, "-m", f"repro_torch.examples.{name}", "--device", "cpu", *args]


def run_both(name: str, timeout: float = 300) -> tuple[list[str], list[str]]:
    """(JAX script's lines, port's lines), the two run concurrently."""
    jax = start([sys.executable, str(ROOT / "examples" / f"{name}.py")])
    port = start(port_cmd(name))
    return finish(jax, timeout).splitlines(), finish(port, timeout).splitlines()


def numbers(line: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.\d+|-?\d+", line)]


#: runs ``repro_torch.examples.<argv[1]>`` with ``argv[3:]`` under
#: ``chip_smoke.recording_labels`` (the labels of every ``hdc_model.predict``
#: call) and saves them to the ``.npz`` file ``argv[2]``
_RECORD_LABELS = """
import importlib, sys
import numpy as np
import chip_smoke
labels = []
with chip_smoke.recording_labels(labels):
    rc = importlib.import_module("repro_torch.examples." + sys.argv[1]).main(sys.argv[3:])
np.savez(sys.argv[2], *labels)
sys.exit(rc)
"""


def run_both_recording_labels(name: str, npz: pathlib.Path,
                              timeout: float = 300) -> tuple[list[str], list[str], list]:
    """(JAX script's lines, port's lines, the port's predicted labels, one
    array a ``predict`` call in call order), the two run concurrently."""
    jax = start([sys.executable, str(ROOT / "examples" / f"{name}.py")])
    port = start([sys.executable, "-c", _RECORD_LABELS, name, str(npz), "--device", "cpu"])
    jax_lines, port_lines = finish(jax, timeout).splitlines(), finish(port, timeout).splitlines()
    with np.load(npz) as f:
        labels = [f[f"arr_{i}"] for i in range(len(f.files))]
    return jax_lines, port_lines, labels


#: the models of the examples that print a cosine accuracy, one a printed
#: accuracy: (dataset, training images, test images, ``HDCConfig`` keywords
#: of each model); each loads 2,048 training and 512 test images and uses
#: the first of them, as the example does
EXAMPLE_FITS = {
    "quickstart": ("mnist", 2048, 512, [dict(d=4096)] + [
        dict(d=4096, encoder="baseline", seed=i) for i in range(3)]),  # baseline_iterative_search
    "hdc_at_scale": ("synth_mnist", 512, 256, [dict(d=1024)]),
}


def jax_example_labels(name: str) -> tuple[np.ndarray, list[tuple[np.ndarray, np.ndarray]]]:
    """The test labels of an example of EXAMPLE_FITS, and for each of its
    models the JAX package's predicted labels and each image's top-2
    cosine margin."""
    import jax.numpy as jnp

    from repro.core import HDCConfig, HDCModel, metrics
    from repro.data import load_dataset

    dataset, n_train, n_test, fits = EXAMPLE_FITS[name]
    ds = load_dataset(dataset, n_train=2048, n_test=512)
    x, y, q = ds.train_images[:n_train], ds.train_labels[:n_train], ds.test_images[:n_test]
    out = []
    for kw in fits:
        model = HDCModel.create(HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes,
                                          **kw)).fit(x, y)
        sim = np.asarray(metrics.SIMILARITIES["cosine"](model.encode(jnp.asarray(q)),
                                                       model.class_hvs))
        top2 = np.sort(sim, axis=-1)[:, -2:]
        out.append((np.asarray(model.predict(q)), top2[:, 1] - top2[:, 0]))
    return ds.test_labels[:n_test], out


def chip_label_constants(refs: list[tuple[np.ndarray, np.ndarray]]) -> list[dict]:
    """``chip_smoke.py``'s JAX_EXAMPLE_LABELS entry of an example: each
    model's near-tie images and ``chip_smoke.labels_sha256`` of JAX's
    labels.  Made by
    ``JAX_PLATFORMS=cpu PYTHONPATH=src:tests python -c "from
    test_torch_examples_common import *; print({n: chip_label_constants(
    jax_example_labels(n)[1]) for n in EXAMPLE_FITS})"``."""
    sha256, out = chip_smoke().labels_sha256, []
    for labels, margins in refs:
        ties = np.nonzero(margins < NEAR_TIE)[0].tolist()
        out.append({"sha256": sha256(labels, ties), "near_ties": ties})
    return out


def accuracy(labels: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean(labels == truth))


def assert_labels_differ_only_on_near_ties(port: np.ndarray, jax: np.ndarray,
                                           margins: np.ndarray) -> None:
    """Every image whose label the port moves is one of JAX's near-ties."""
    moved = np.nonzero(port != jax)[0]
    far = moved[margins[moved] >= NEAR_TIE]
    assert far.size == 0, f"labels moved at images {far.tolist()}, JAX's margins {margins[far]}"


def chip_smoke():
    """``chip_smoke.py`` as a module (it runs nothing at import)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
