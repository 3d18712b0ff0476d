"""Helpers of the LM parity tests (``test_torch_lm_*.py``): JAX's smoke
parameters as numpy, seeded inputs, and one run of the full forward,
prefill and teacher-forced decode through both packages."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import params as jparams_mod
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.models import params as tparams_mod
from repro_torch.models import transformer as tt


def as_f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    cfg = jget_smoke(arch)
    tree = jax.jit(lambda k: jparams_mod.init_params(cfg, k))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def fixed_params(arch: str):
    """The port's smoke parameters of seed 0, as JAX's tree of numpy arrays:
    the same weights in every process (JAX's own init draws new ones)."""
    return convert.jax_params_from_lm(tparams_mod.init_params(tget_smoke(arch), 0, "cpu"))


def batch_for(cfg, b: int, s: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.n_ctx_tokens:
        out["ctx"] = rng.standard_normal((b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return out


def cut(batch: dict, lo: int, hi: int) -> dict:
    return {k: (v if k == "ctx" else v[:, lo:hi]) for k, v in batch.items()}


def run_both(jcfg, tcfg, jtree, batch: dict, s: int, n_dec: int):
    """Full-forward logits, prefill logits on the first s positions and
    n_dec teacher-forced decode steps, from JAX (jitted) and the port."""
    tparams = convert.lm_params_from_jax(tcfg, jtree, "cpu")
    jp = jax.tree.map(jnp.asarray, jtree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def jfull(p, b):
        n = b["tokens"].shape[1]
        pos = jnp.arange(n)[None]
        x = jt.embed_inputs(jcfg, p, b, pos)
        x, _, _ = jt.run_stack(jcfg, p, x, mode="train", positions=pos, ctx=b.get("ctx"))
        return jt.unembed(jcfg, p, jt.layers.rms_norm(x, p["final_norm"]))

    jout = [np.asarray(jax.jit(jfull)(jp, jb))]
    tout = [tt.forward_logits(tcfg, tparams, tb).numpy()]
    jl, jst = jax.jit(lambda p, b: jt.prefill(jcfg, p, b))(jp, cut(jb, 0, s))
    tl, tst = tt.prefill(tcfg, tparams, cut(tb, 0, s))
    jout.append(np.asarray(jl))
    tout.append(tl.numpy())
    jdec = jax.jit(lambda p, st, tok, ex: jt.decode_step(jcfg, p, st, tok, **ex))
    for i in range(s, s + n_dec):
        step = cut(batch, i, i + 1)
        extra = {k: v for k, v in step.items() if k == "embeddings"}
        jl, jst = jdec(jp, jst, jnp.asarray(step["tokens"]), {k: jnp.asarray(v) for k, v in extra.items()})
        tl, tst = tt.decode_step(tcfg, tparams, tst, torch.from_numpy(step["tokens"]),
                                 **{k: torch.from_numpy(v) for k, v in extra.items()})
        jout.append(np.asarray(jl))
        tout.append(tl.numpy())
    return jout, tout


def flat_keys(tree, prefix: str = "") -> list[str]:
    """Leaf keys of a nested dict in sorted-key order (``jax.tree.leaves``'s)."""
    if isinstance(tree, dict):
        return [k for key in sorted(tree) for k in flat_keys(tree[key], f"{prefix}{key}/")]
    return [prefix[:-1]]


def loss_and_grads_both(jcfg, tcfg, jtree, batch: dict):
    """(loss, grads) of ``loss_fn`` from ``jax.value_and_grad`` (jitted) and
    from the port's autograd (``training.step.loss_and_grads``), the
    gradients as numpy lists in ``jax.tree.leaves`` order."""
    from repro_torch.training.step import loss_and_grads
    from repro_torch.tree import tree_leaves

    jp = jax.tree.map(jnp.asarray, jtree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.jit(jax.value_and_grad(lambda p, b: jt.loss_fn(jcfg, p, b), has_aux=True))
    (jl, jm), jg = vg(jp, jb)
    tparams = convert.lm_params_from_jax(tcfg, jtree, "cpu")
    tl, tm, tg = loss_and_grads(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    return ((float(jl), {k: float(v) for k, v in jm.items()}, [np.asarray(g) for g in jax.tree.leaves(jg)]),
            (float(tl), {k: float(v) for k, v in tm.items()}, [g.float().numpy() for g in tree_leaves(tg)]))


def check_loss_and_grads(arch: str, **overrides) -> None:
    """The loss and gradient checks of ``test_torch_lm_train_loss.py``
    (its docstring states the tolerances) for one smoke arch, its config
    fields replaced by `overrides`."""
    jc = dataclasses.replace(as_f32(jget_smoke(arch)), **overrides)
    tc = dataclasses.replace(as_f32(tget_smoke(arch)), **overrides)
    tree = fixed_params(arch)
    batch = batch_for(jc, 2, 16, seed=1)
    (jl, jm, jg), (tl, tm, tg) = loss_and_grads_both(jc, tc, tree, batch)
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-5, (tl, jl)
    for k in ("ce", "aux", "tokens"):
        assert abs(tm[k] - jm[k]) <= 1e-5, (k, tm[k], jm[k])
    total = np.sqrt(sum(float(np.sum(np.square(g))) for g in jg))
    keys = flat_keys(tree)
    assert len(tg) == len(jg) == len(keys)
    for key, t, j in zip(keys, tg, jg):
        assert t.shape == j.shape and np.isfinite(t).all(), key
        norm = float(np.linalg.norm(j))
        bound = 1e-4 * norm if norm >= 1e-5 * total else 1e-6
        assert float(np.abs(t - j).max()) <= bound, (key, float(np.abs(t - j).max()), norm)
