"""The port's train step and token pipeline against the JAX package's, on
the CPU.

* Three steps of ``make_train_step`` against JAX's jitted
  ``make_train_step`` on qwen3-0.6b's and olmoe-1b-7b's smoke configs in
  float32 compute, fed JAX's ``TokenPipeline`` batches, from the port's
  seed-0 weights carried to JAX (fixed in every process; JAX's own init
  is salted per process): each step's loss within 1e-4 (and ``grad_norm``, ``lr``, ``ce``,
  ``aux``, ``tokens`` likewise), the params after within atol 2e-3 / rtol
  1e-3 (JAX's accumulation-order tolerance, tests/test_components.py:251).
* ``grad_accum`` 1 and 4 agree as in tests/test_components.py:229.
* Every arch's smoke config takes a bf16 step with finite loss and
  ``grad_norm`` and moves its params (JAX's ``test_smoke_train_step``).
* ``TokenPipeline``: the threefry uniforms are bit-exact, and the tokens
  equal JAX's except where either package's float32 ``exp(u * log V)``
  lies within 2 ulp of an integer (or a position copies such a token from
  two back): XLA's float32 ``exp`` and torch's differ in the last bit
  there, and the truncation moves the token by one.  Over 20 steps of
  (8, 256) at vocab 151,936 and 512 and of (16, 128) at 2,048 (122,880
  tokens), 6 differ (ROADMAP §3).  Determinism and the per-host slices
  as in tests/test_distributed.py:257; the "embeddings" and "ctx" draws
  by shape, dtype and moments.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_smoke_config as jget_smoke
from repro.data.tokens import TokenPipeline as JPipe
from repro.optim import OptimizerConfig as JOpt, init_opt_state as jinit_opt
from repro.training.step import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.core import prng
from repro_torch.data.tokens import TokenPipeline as TPipe, pipeline_for
from repro_torch.models import params as tparams_mod
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import OptimizerConfig as TOpt, init_opt_state as tinit_opt
from repro_torch.training.step import make_train_step as tmake_step
from repro_torch.tree import tree_leaves
from torch_lm_parity import as_f32, batch_for, fixed_params

OPT = dict(warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_three_train_steps_equal_jax(arch):
    jc, tc = as_f32(jget_smoke(arch)), as_f32(tget_smoke(arch))
    tree = fixed_params(arch)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jinit_opt(jp)
    tp = convert.lm_params_from_jax(tc, tree, "cpu")
    to = tinit_opt(tp)
    jstep = jax.jit(jmake_step(jc, JOpt(**OPT)))
    tstep = tmake_step(tc, TOpt(**OPT))
    pipe = JPipe(jc.vocab_size, 32, 4, seed=0)
    for step in range(3):
        batch = {k: np.asarray(v) for k, v in pipe.batch_at(step).items()}
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(step))
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v.copy()) for k, v in batch.items()}, step)
        assert set(tm) == set(jm)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * max(1.0, abs(float(jm[k]))), (step, k)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-3, rtol=1e-3)
    for a, b in zip(jax.tree.leaves(jo), tree_leaves(to["m"]) + tree_leaves(to["v"])):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape


def test_grad_accum_matches_full_batch():
    """The port of tests/test_components.py's accumulation test: the mean
    of 4 microbatches' gradients is the full batch's (uniform mask)."""
    cfg = tget_smoke("qwen3-0.6b")
    batch = {"tokens": torch.from_numpy(batch_for(cfg, 4, 16, seed=4)["tokens"])}
    ocfg = TOpt(warmup_steps=0, schedule="constant", clip_norm=1e9)
    runs = []
    for accum in (1, 4):
        params = tparams_mod.init_params(cfg, 0, "cpu")
        params, _, metrics = tmake_step(cfg, ocfg, grad_accum=accum)(
            params, tinit_opt(params), batch, 0)
        runs.append((params, metrics))
    (p1, m1), (p4, m4) = runs
    assert set(m1) == {"loss", "grad_norm", "lr", "ce", "aux", "tokens"}
    assert set(m4) == {"loss", "grad_norm", "lr"}  # loss_fn's scalars only without accumulation
    np.testing.assert_allclose(m4["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step_every_arch(arch):
    cfg = tget_smoke(arch)
    params = tparams_mod.init_params(cfg, 0, "cpu")
    before = [t.clone() for t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg, 2, 16, seed=1).items()}
    step = tmake_step(cfg, TOpt(warmup_steps=0, total_steps=10, schedule="constant"))
    params, opt, metrics = step(params, tinit_opt(params), batch, 0)
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())
    assert not torch.allclose(before[0], tree_leaves(params)[0])
    assert all(t.dtype == torch.float32 for t in tree_leaves(opt))


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------


def _near_integer(e: np.ndarray) -> np.ndarray:
    return np.abs(e - np.round(e)) <= 2 * np.spacing(np.abs(e).astype(np.float32))


def test_token_batches_equal_jax_except_at_float32_exp_near_integers():
    n_tok = n_diff = n_exempt = 0
    for vocab, b, s in [(151_936, 8, 256), (512, 8, 256), (2_048, 16, 128)]:
        jpipe, tpipe = JPipe(vocab, s, b, seed=0), TPipe(vocab, s, b, seed=0)
        for step in range(20):
            want = np.asarray(jpipe.batch_at(step)["tokens"])
            got = tpipe.host_batch(step)["tokens"]
            assert got.dtype == torch.int32 and tuple(got.shape) == (b, s)
            got = got.numpy()
            kz, kr, _, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), step), 4)
            u = np.array(jax.random.uniform(kz, (b, s)))
            key = prng.fold_in(prng.prng_key(0), step)
            np.testing.assert_array_equal(prng.uniform(prng.split(key, 4)[0], (b, s)), u)
            e_jax = np.asarray(jnp.exp(jnp.asarray(u) * np.log(vocab)))
            e_port = torch.exp(torch.from_numpy(u) * torch.tensor(np.float32(np.log(vocab)))).numpy()
            exempt = _near_integer(e_jax) | _near_integer(e_port)
            rep = np.asarray(jax.random.uniform(kr, (b, s)) < 0.35)
            exempt |= rep & np.roll(exempt, 2, axis=1)
            np.testing.assert_array_equal(got[~exempt], want[~exempt])
            n_tok += want.size
            n_diff += int((got != want).sum())
            n_exempt += int(exempt.sum())
    assert n_tok == 122_880 and n_diff <= 6 and n_diff <= n_exempt, (n_diff, n_exempt)


def test_token_pipeline_deterministic_and_host_slices():
    p = TPipe(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    a, b = p.batch_at(5, "cpu"), TPipe(100, 16, 8, seed=3).batch_at(5, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], p.batch_at(6, "cpu")["tokens"])
    h0 = p.host_batch_at(5, 0, 2, "cpu")["tokens"]
    h1 = p.host_batch_at(5, 1, 2, "cpu")["tokens"]
    assert torch.equal(torch.cat([h0, h1]), a["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) <= 99


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-90b"])
def test_embedding_and_context_draws_match_jax_in_shape_dtype_and_moments(arch):
    jc, tc = jget_smoke(arch), tget_smoke(arch)
    shape = ShapeConfig("t", 64, 8, "train")
    from repro.data.tokens import pipeline_for as jpipeline_for

    want = jpipeline_for(jc, shape, seed=1).batch_at(2)
    got = pipeline_for(tc, shape, seed=1).batch_at(2, "cpu")
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        if k == "tokens":
            continue
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16
        x = got[k].float().numpy()
        assert abs(x.mean()) < 0.05 and abs(x.std() - 1.0) < 0.05, (k, x.mean(), x.std())
        assert np.abs(x).max() < 6.5
    assert dataclasses.asdict(pipeline_for(tc, shape, seed=1)) == \
        dataclasses.asdict(jpipeline_for(jc, shape, seed=1))
