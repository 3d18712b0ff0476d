"""The dry-run's counts and its HDC fit (``repro_torch.launch.dryrun``):
the flop and byte counts on ``meta`` tensors against the same counts on
real CPU tensors, the count against ``model_flops``, and ``run_hdc``'s
class sums against the JAX package's fit on the same images.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch


def meta_mesh(shape, axes):
    """A mesh whose every cell is the ``meta`` device."""
    from repro_torch.distributed.sharding import Mesh

    return Mesh(np.array([torch.device("meta")] * int(np.prod(shape)), dtype=object).reshape(shape),
                axes)


def _smoke_step_inputs(arch: str, real: bool):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import abstract_params
    from repro_torch.launch import specs
    from repro_torch.models import params as pmod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import init_opt_state

    cfg = get_smoke_config(arch)
    shape = ShapeConfig("smoke", 64, 4, "train")
    if real:
        params = pmod.init_params(cfg, 0, "cpu")
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 64)).astype(np.int32))
        return cfg, shape, {"params": params, "opt_state": init_opt_state(params),
                            "batch": {"tokens": tokens}}
    mesh = meta_mesh((1, 1), ("data", "model"))
    rules = specs.rules_for(cfg)
    return cfg, shape, {"params": abstract_params(cfg, mesh, rules),
                        "opt_state": specs.abstract_opt_state(cfg, mesh, rules),
                        "batch": specs.batch_specs(cfg, shape, mesh, rules)}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "recurrentgemma-2b"])
def test_flop_count_on_meta_equals_the_count_on_cpu_tensors(arch):
    from repro_torch.launch import dryrun

    meta = dryrun.count_step(*_smoke_step_inputs(arch, real=False))
    real = dryrun.count_step(*_smoke_step_inputs(arch, real=True))
    assert meta["flops"] == real["flops"] > 0
    assert meta["bytes"] == real["bytes"] > 0
    assert meta["peak_global"] >= meta["inputs_global"] > 0


def test_flop_count_lies_within_its_stated_ratio_of_model_flops():
    """FlopCounterMode counts the matmuls, among them the attention scores
    and values that 6*N*T leaves out, and not the embedding lookup that
    N includes; at the smoke step (4 x 64 tokens, 2 layers of d_model 64)
    that puts the count between 1.0 and 1.5 times ``model_flops``."""
    from repro_torch.analysis import roofline
    from repro_torch.launch import dryrun

    cfg, shape, inputs = _smoke_step_inputs("qwen3-0.6b", real=False)
    ratio = dryrun.count_step(cfg, shape, inputs)["flops"] / roofline.model_flops(cfg, shape, 1)
    assert 1.0 <= ratio <= 1.5, ratio


def test_run_hdc_class_sums_equal_jax_fit_on_the_same_images():
    from repro.core import HDCConfig, HDCModel
    from repro_torch.launch import dryrun

    rec = dryrun.run_hdc(d=64, device="cpu", verbose=False)
    images, labels = dryrun.hdc_data()
    assert images.shape == (65536, 784) and set(np.unique(labels)) == set(range(16))
    jm = HDCModel.create(HDCConfig(n_features=784, n_classes=16, d=64)).fit(images, labels)
    sums = np.asarray(jm.class_sums).astype("<i4")
    assert rec["class_sums_sha256"] == hashlib.sha256(sums.tobytes()).hexdigest()
    assert rec["n_seen"] == 65536 and rec["timed_by"] == "perf_counter"
    # the production mesh's per-device bytes: images over data (16), D over model (16)
    assert rec["per_device_bytes"] == {"images": 4096 * 784 * 4, "labels": 4096 * 4,
                                       "sobol": 784 * 4, "class_sums": 16 * 4 * 4}
    assert 0 < rec["bound_ms"] < rec["fit_ms"]


def test_run_hdc_raises_without_a_card_unless_given_the_cpu_and_cells_need_none(monkeypatch,
                                                                                tmp_path):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_hdc(d=64, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "hdc_mnist", "--out", str(tmp_path)])
    # a meta cell runs without any device
    rec = dryrun.run_cell("xlstm-1.3b", "long_500k", verbose=False)
    assert rec["raw"]["flops_global"] > 0 and rec["memory"]["argument_bytes"] > 0
