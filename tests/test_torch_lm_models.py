"""The port's LM configs, spec trees, parameters and layers against the JAX
package's, and the serving path's traps (the blocked prefill, gemma3's
rolling window), on the CPU.

JAX's ``init_params`` salts its per-leaf keys with Python's ``hash()``, so
its weights differ from process to process: every parity test carries
JAX's parameters across (``convert.lm_params_from_jax``).  Inputs come from
numpy with a seed.  The whole stack per arch is held in
``test_torch_lm_stack.py`` (float32) and ``test_torch_lm_bf16.py``.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget_config, get_smoke_config as jget_smoke
from repro.models import config as jconfig, layers as jlayers, params as jparams_mod
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config as tget_config, get_smoke_config as tget_smoke
from repro_torch.distributed import sharding as tsharding
from repro_torch.models import config as tconfig, layers as tlayers, params as tparams_mod
from repro_torch.models import transformer as tt
from torch_lm_parity import batch_for, as_f32, jax_params, run_both

SRC = Path(__file__).resolve().parents[1] / "src"


# ---------------------------------------------------------------------------
# Configs and spec trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jax(arch):
    for jget, tget in ((jget_config, tget_config), (jget_smoke, tget_smoke)):
        jc, tc = jget(arch), tget(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for prop in ("period", "n_groups", "tail_pattern", "q_per_kv", "rec_dim",
                     "xlstm_inner", "xlstm_head_dim"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        assert tc.cdtype() == getattr(torch, str(jc.cdtype()))
        assert tc.pdtype() == getattr(torch, str(jc.pdtype()))
    jc, tc = jget_config(arch), tget_config(arch)
    assert tc.n_params() == jc.n_params()
    assert tc.n_active_params() == jc.n_active_params()


def test_shapes_registry_and_unknown_arch():
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()
    }
    assert tconfig.LONG_CONTEXT_OK == jconfig.LONG_CONTEXT_OK
    with pytest.raises(ValueError, match="unknown arch"):
        tget_config("no-such-arch")


def _spec_tuples(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_spec_tuples(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), tuple(v.axes), v.init, v.std)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_axes_equal_jax(arch):
    for jget, tget in ((jget_config, tget_config), (jget_smoke, tget_smoke)):
        jc, tc = jget(arch), tget(arch)
        assert _spec_tuples(tparams_mod.param_specs(tc)) == _spec_tuples(jparams_mod.param_specs(jc))
        assert tparams_mod.spec_tree_axes(tc) == jparams_mod.spec_tree_axes(jc)
    tc = tget_smoke(arch)
    jaxes = jt.decode_state_axes(jget_smoke(arch))
    assert tt.decode_state_axes(tc) == jaxes
    # the allocated state has the tree and shapes of JAX's
    jstate = jax.eval_shape(lambda: jt.init_decode_state(jget_smoke(arch), 2, 24))
    tstate = tt.init_decode_state(tc, 2, 24, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tstate)[0]
    assert [(jax.tree_util.keystr(p), tuple(v.shape)) for p, v in jflat] == [
        (jax.tree_util.keystr(p), tuple(v.shape)) for p, v in tflat
    ]
    assert [str(v.dtype) for _, v in jflat] == [str(v.dtype).removeprefix("torch.") for _, v in tflat]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def test_init_params_is_seeded_and_stable_across_processes():
    cfg = tget_smoke("qwen3-0.6b")
    a = tparams_mod.init_params(cfg, 3, "cpu")
    b = tparams_mod.init_params(cfg, 3, "cpu")
    c = tparams_mod.init_params(cfg, 4, "cpu")
    flat = lambda t: jax.tree_util.tree_leaves(t)  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert a["final_norm"].eq(1).all() and a["embed"].dtype == torch.float32
    assert abs(float(a["embed"].std()) - 1 / 8) < 0.01  # std 1/sqrt(d_model)
    code = (
        "import torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models.params import init_params\n"
        "p = init_params(get_smoke_config('qwen3-0.6b'), 3, 'cpu')\n"
        "print(repr(float(p['embed'].double().sum())), repr(float(p['blocks']['sub0']['mixer']['wq'].double().sum())))\n"
    )
    outs = set()
    for hashseed in ("1", "2"):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=str(SRC), PYTHONHASHSEED=hashseed))
        assert out.returncode == 0, out.stderr
        outs.add(out.stdout)
    want = f"{float(a['embed'].double().sum())!r} {float(a['blocks']['sub0']['mixer']['wq'].double().sum())!r}\n"
    assert outs == {want}


def test_lm_params_round_trip_and_checks():
    cfg = tget_smoke("recurrentgemma-2b")
    p = tparams_mod.init_params(cfg, 0, "cpu")
    tree = convert.jax_params_from_lm(p)
    back = convert.lm_params_from_jax(cfg, tree, "cpu")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(p)
    assert all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)))
    # JAX's own tree has the same key paths and shapes
    jtree = jax_params("recurrentgemma-2b")
    assert jax.tree_util.tree_structure(jtree) == jax.tree_util.tree_structure(tree)
    bad = dict(tree, extra=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params_from_jax(cfg, bad, "cpu")
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_jax(cfg, bad, "cpu")
    bf = {**tree, "final_norm": tree["final_norm"].astype(jnp.bfloat16)}
    got = convert.lm_params_from_jax(cfg, bf, "cpu")["final_norm"]
    assert got.dtype == torch.bfloat16 and got.eq(1).all()
    assert convert.jax_params_from_lm({"x": got})["x"].dtype == jnp.bfloat16


def test_constrain_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert tsharding.constrain(x, ("data", None, None)) is x
    assert tsharding.constrain_batch(x) is x


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_equal_jax(dtype):
    rng = np.random.default_rng(1)
    x32 = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    jx = jnp.asarray(x32).astype(dtype)
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)

    def same(j, t, **kw):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)), **(kw or tol))

    scale = rng.standard_normal(16).astype(np.float32)
    same(jlayers.rms_norm(jx, jnp.asarray(scale)), tlayers.rms_norm(tx, torch.from_numpy(scale)))
    pos = np.arange(3, 8, dtype=np.int32)[None]
    for base in (10_000.0, 1_000_000.0):
        same(jlayers.rope(jx, jnp.asarray(pos), base), tlayers.rope(tx, torch.from_numpy(pos), base))
    same(jlayers.gelu(jx), tlayers.gelu(tx))
    for cap in (None, 30.0):
        same(jlayers.softcap(jx * 40, cap), tlayers.softcap(tx * 40, cap))
    same(jlayers.sinusoidal_positions(jnp.asarray(pos), 64),
         tlayers.sinusoidal_positions(torch.from_numpy(pos), 64))
    h = rng.standard_normal((2, 5, 8)).astype(np.float32)
    w = {k: rng.standard_normal(s).astype(np.float32) / 3
         for k, s in (("w_up", (8, 12)), ("w_gate", (8, 12)), ("w_down", (12, 8)))}
    for act in ("swiglu", "geglu", "gelu"):
        same(jlayers.ffn({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(h).astype(dtype), act, dtype),
             tlayers.ffn({k: torch.from_numpy(v) for k, v in w.items()},
                         torch.from_numpy(h).to(getattr(torch, dtype)), act, getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# Traps of the serving path
# ---------------------------------------------------------------------------


def test_blocked_prefill_equals_jax_and_the_unblocked_path():
    """Prompts past attn_block_threshold take the online-softmax blocked
    path (self-attention, global and windowed, and cross-attention)."""
    for arch in ("gemma3-12b", "llama-3.2-vision-90b"):
        over = dict(attn_block_threshold=16, attn_block_q=8, attn_block_kv=8)
        jc = dataclasses.replace(as_f32(jget_smoke(arch)), **over)
        tc = dataclasses.replace(as_f32(tget_smoke(arch)), **over)
        batch = batch_for(jc, 2, 34, seed=2)
        jout, tout = run_both(jc, tc, jax_params(arch), batch, s=32, n_dec=2)
        for j, t in zip(jout, tout):
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
        # the unblocked path (threshold out of reach) computes the same
        plain = dataclasses.replace(tc, attn_block_threshold=1 << 30)
        tparams = convert.lm_params_from_jax(tc, jax_params(arch), "cpu")
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        np.testing.assert_allclose(tt.forward_logits(plain, tparams, tb).numpy(), tout[0],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prompt", [5, 12])
def test_gemma3_rolling_window_past_the_window(prompt):
    """The local layers' rolling cache (window 8 at smoke size): decode from
    a prompt shorter and longer than the window to positions past it."""
    jc, tc = as_f32(jget_smoke("gemma3-12b")), as_f32(tget_smoke("gemma3-12b"))
    assert tc.window_size == 8
    batch = batch_for(jc, 2, prompt + 10, seed=3)
    jout, tout = run_both(jc, tc, jax_params("gemma3-12b"), batch, s=prompt, n_dec=10)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    for i in range(11):
        np.testing.assert_allclose(tout[1 + i], tout[0][:, prompt - 1 + i], rtol=1e-4, atol=1e-4)
