"""The port's ``loss_fn`` and its gradients against the JAX package's, on
the CPU, float32 compute, for the attention and MoE archs at their smoke
configs (the recurrent and multimodal ones: ``test_torch_lm_train_loss_rec.py``).
The weights are the port's ``init_params(seed=0)``, carried to JAX
(``convert.jax_params_from_lm``) and back (``lm_params_from_jax``), the
same in every process: JAX's own init is salted per process (ROADMAP
§3), and over six of its draws xLSTM's worst gradient error ranged from
3e-5 to 8.7e-4 of its leaf's norm, so a drawn set would leave the bound
to luck.  The batch comes from numpy with a seed.

* the loss within 1e-5 of ``jax.value_and_grad``'s, and its ``ce``, ``aux``
  and ``tokens`` likewise;
* every gradient leaf within 1e-4 of JAX's relative to that leaf's norm
  (max abs difference <= 1e-4 * ||leaf||).  A leaf whose JAX gradient is
  below 1e-5 of the whole gradient's norm has an analytic zero gradient
  and is held to 1e-6 absolute instead: the mLSTM's input-gate biases (a
  common shift of a head's input gates scales the memory and its
  normalizer alike; rounding noise of ~2e-7 remains), the VLM's
  cross-attention projections behind its closed gate (tanh(0) = 0) and
  musicgen's unused token embedding (both exactly 0).

Then the port's own equivalences (no JAX): remat on and off, with the
"nothing" and "dots" policies, give bit-identical losses and gradients on
the CPU (a recompute repeats the same operations); ``loss_seq_chunks`` 1
and 4 agree to float32 rounding (the chunks sum in another order), and
the compute-dtype copy of the tied embedding made once a step (``_Cast``)
gives each use's gradient as a per-use cast does, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.models import params as tparams_mod
from repro_torch.models import transformer as tt
from repro_torch.training.step import loss_and_grads
from repro_torch.tree import tree_leaves
from torch_lm_parity import as_f32, batch_for, check_loss_and_grads

ARCHS_HERE = ("gemma-7b", "qwen3-0.6b", "gemma3-12b", "qwen3-32b", "moonshot-v1-16b-a3b",
              "olmoe-1b-7b")


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_loss_and_grads_equal_jax_float32(arch):
    check_loss_and_grads(arch)


def test_blocked_attention_grads_equal_jax():
    """The online-softmax blocked attention under autograd: gemma3's smoke
    config with 8-wide blocks from 16 tokens on (its local layers' window
    is 8, so some query blocks see a KV block with no visible key).  The
    port skips those blocks, JAX's scan visits them: the same loss and
    gradients, all finite."""
    check_loss_and_grads("gemma3-12b", attn_block_threshold=16, attn_block_q=8, attn_block_kv=8)


def _grads(cfg, params, batch):
    loss, metrics, grads = loss_and_grads(cfg, params, batch)
    return loss, [g for g in tree_leaves(grads)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "gemma3-12b"])
def test_remat_on_and_off_are_bit_identical(arch):
    base = as_f32(tget_smoke(arch))
    params = tparams_mod.init_params(base, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_for(base, 2, 16, seed=2).items()}
    l0, g0 = _grads(dataclasses.replace(base, remat=False), params, batch)
    for policy in ("nothing", "dots"):
        l1, g1 = _grads(dataclasses.replace(base, remat=True, remat_policy=policy), params, batch)
        assert torch.equal(l0, l1), policy
        assert all(torch.equal(a, b) for a, b in zip(g0, g1)), policy


def test_loss_seq_chunks_1_and_4_agree():
    base = as_f32(tget_smoke("qwen3-0.6b"))
    params = tparams_mod.init_params(base, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_for(base, 2, 16, seed=3).items()}
    l1, g1 = _grads(dataclasses.replace(base, loss_seq_chunks=1), params, batch)
    l4, g4 = _grads(dataclasses.replace(base, loss_seq_chunks=4), params, batch)
    np.testing.assert_allclose(l4.item(), l1.item(), rtol=1e-6)
    for a, b in zip(g1, g4):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)
    # 5 chunks do not divide S = 16: one chunk, as in JAX
    l5, _ = _grads(dataclasses.replace(base, loss_seq_chunks=5), params, batch)
    assert torch.equal(l5, l1)


def test_cast_once_gives_each_use_the_per_use_cast_gradient():
    w = torch.randn(6, 5, dtype=torch.float32)
    xs = [torch.randn(3, 6).to(torch.bfloat16) for _ in range(4)]

    def grad(use):
        wl = w.clone().requires_grad_(True)
        loss = sum(((x @ use(wl)).float() ** 2).sum() for x in xs)
        return torch.autograd.grad(loss, wl)[0]

    once = w.to(torch.bfloat16)
    per_use = grad(lambda wl: wl.to(torch.bfloat16))
    cast_once = grad(lambda wl: tt._Cast.apply(wl, once))
    assert cast_once.dtype == torch.float32 and torch.equal(cast_once, per_use)
