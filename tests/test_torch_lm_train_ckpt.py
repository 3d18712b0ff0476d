"""The port's ``CheckpointManager`` additions of the training slice,
against the JAX package's on the CPU.

* ``save(..., blocking=False)`` copies the tree before it returns: the
  port's step updates its tensors in place, and the saved leaves equal
  the step's values after the next step has run;
* a write error surfaces at the next ``wait()`` (and once);
* bfloat16 leaves round-trip through both packages, byte for byte
  (``uint16`` bits, ``"dtype": "bfloat16"`` in the manifest);
* a JAX-written train checkpoint (``{"params", "opt"}``, smoke config)
  restores in the port and continues, and the reverse; both write the
  same leaf keys in the same (sorted) order.  The continued steps agree
  with the writer's own continuation to the train step's tolerances
  (loss 1e-4; params atol 2e-3, rtol 1e-3).
"""

from __future__ import annotations

import json
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_smoke_config as jget_smoke
from repro.data.tokens import TokenPipeline as JPipe
from repro.optim import OptimizerConfig as JOpt, init_opt_state as jinit_opt
from repro.training.step import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.optim import OptimizerConfig as TOpt, init_opt_state as tinit_opt
from repro_torch.training.step import make_train_step as tmake_step
from repro_torch.tree import tree_leaves, tree_map
from torch_lm_parity import as_f32, fixed_params

ARCH = "qwen3-0.6b"
OPT = dict(warmup_steps=2, total_steps=10)


def test_async_save_holds_the_step_it_was_given(tmp_path):
    cfg = as_f32(tget_smoke(ARCH))
    params = convert.lm_params_from_jax(cfg, fixed_params(ARCH), "cpu")
    opt = tinit_opt(params)
    step = tmake_step(cfg, TOpt(**OPT))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))}
    params, opt, _ = step(params, opt, batch, 0)
    want = [t.clone() for t in tree_leaves({"params": params, "opt": opt})]
    mgr = TManager(tmp_path)
    mgr.save(1, {"params": params, "opt": opt}, blocking=False)
    params, opt, _ = step(params, opt, batch, 1)  # in place, while the writer runs
    mgr.wait()
    assert mgr.latest_step() == 1
    got = tree_leaves(mgr.restore(1, {"params": params, "opt": opt}))
    moved = 0
    for w, g, now in zip(want, got, tree_leaves({"params": params, "opt": opt})):
        np.testing.assert_array_equal(g, w.numpy())
        moved += not torch.equal(now, w)
    assert moved > 0  # the next step did change the tensors


def test_write_error_surfaces_at_wait_once(tmp_path):
    root = tmp_path / "ckpt"
    mgr = TManager(root)
    shutil.rmtree(root)
    root.write_text("not a directory")
    mgr.save(3, {"a": torch.ones(3)}, blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once
    with pytest.raises(OSError):
        mgr.save(4, {"a": torch.ones(3)})


def test_bf16_leaves_round_trip_through_both_packages(tmp_path):
    bits = np.random.default_rng(0).integers(0, 2**16, (4, 6), dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0  # no NaN / inf patterns
    t_leaf = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    TManager(tmp_path / "port").save(1, {"b": {"c": t_leaf}, "f": torch.arange(3.0)})
    manifest = json.loads((tmp_path / "port" / "step_000000001" / "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == ["bfloat16", "float32"]
    got = JManager(tmp_path / "port").restore(1, {"b": {"c": jnp.zeros((4, 6), jnp.bfloat16)},
                                                  "f": jnp.zeros(3)})
    assert got["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]).view(np.uint16), bits)

    JManager(tmp_path / "jax").save(2, {"b": {"c": jnp.asarray(bits.view(ml_dtypes.bfloat16))}})
    back = TManager(tmp_path / "jax").restore(2, {"b": {"c": (4, 6)}})["b"]["c"]
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.view(torch.int16).numpy().view(np.uint16), bits)


def _both(n_steps: int):
    """(JAX state, port state) after n_steps from JAX's weights, float32."""
    jc, tc = as_f32(jget_smoke(ARCH)), as_f32(tget_smoke(ARCH))
    tree = fixed_params(ARCH)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jinit_opt(jp)
    tp = convert.lm_params_from_jax(tc, tree, "cpu")
    to = tinit_opt(tp)
    return jc, tc, jp, jo, tp, to


def _batch(step: int):
    return {k: np.asarray(v) for k, v in JPipe(512, 32, 4, seed=0).batch_at(step).items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_checkpoint_restores_across_packages_and_continues(tmp_path, writer):
    jc, tc, jp, jo, tp, to = _both(0)
    jstep = jax.jit(jmake_step(jc, JOpt(**OPT)))
    tstep = tmake_step(tc, TOpt(**OPT))
    for step in range(2):
        b = _batch(step)
        if writer == "jax":
            jp, jo, _ = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(step))
        else:
            tp, to, _ = tstep(tp, to, {k: torch.from_numpy(v.copy()) for k, v in b.items()}, step)
    if writer == "jax":
        JManager(tmp_path).save(2, {"params": jp, "opt": jo})
        restored = TManager(tmp_path).restore(2, {"params": tp, "opt": to})
        tree_map(lambda t, a: t.copy_(torch.as_tensor(a)), {"params": tp, "opt": to}, restored)
    else:
        TManager(tmp_path).save(2, {"params": tp, "opt": to})
        jstate = JManager(tmp_path).restore(2, {"params": jp, "opt": jo})
        jp, jo = jstate["params"], jstate["opt"]
    keys = [m["key"] for m in json.loads((tmp_path / "step_000000002" / "manifest.json").read_text())["leaves"]]
    assert keys == sorted(keys) and len(keys) == 3 * len(jax.tree.leaves(jp))
    for a, b in zip(jax.tree.leaves({"params": jp, "opt": jo}), tree_leaves({"params": tp, "opt": to})):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))  # restored bit for bit
    b = _batch(2)
    jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(2))
    tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v.copy()) for k, v in b.items()}, 2)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-3, rtol=1e-3)
