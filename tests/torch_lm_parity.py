"""Helpers of the LM parity tests (``test_torch_lm_*.py``): JAX's smoke
parameters as numpy, seeded inputs, and one run of the full forward,
prefill and teacher-forced decode through both packages."""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

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

SRC = Path(__file__).resolve().parents[1] / "src"
#: the relative weight change of the conditioning witness (:func:`moved`)
MOVE = 1e-6


def as_f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    """JAX's smoke parameters as its ``init_params`` draws them in this
    process.  It salts each leaf's key with Python's ``hash()`` of the
    leaf's path, so the weights differ from process to process (with
    ``PYTHONHASHSEED``): checks held to a fixed tolerance take
    :func:`fixed_params`, and a given draw is reproduced by
    :func:`draw_jax_params`."""
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


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg):
    """JAX's jitted full forward, prefill and decode step for `jcfg`, made
    once per config so that each compiles once per shape."""

    def full(p, b):
        n = b["tokens"].shape[1]
        pos = jnp.arange(n)[None]
        x = jt.embed_inputs(jcfg, p, b, pos)
        x, _, _ = jt.run_stack(jcfg, p, x, mode="train", positions=pos, ctx=b.get("ctx"))
        return jt.unembed(jcfg, p, jt.layers.rms_norm(x, p["final_norm"]))

    return (jax.jit(full), jax.jit(lambda p, b: jt.prefill(jcfg, p, b)),
            jax.jit(lambda p, st, tok, ex: jt.decode_step(jcfg, p, st, tok, **ex)))


def jax_run(jcfg, jtrees: list, batch: dict, s: int, n_dec: int) -> list[list[np.ndarray]]:
    """For each tree of `jtrees`: JAX's full-forward logits, prefill logits
    on the first s positions and n_dec teacher-forced decode steps (jitted)."""
    full, pre, dec = _jax_fns(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    outs = []
    for jtree in jtrees:
        jp = jax.tree.map(jnp.asarray, jtree)
        out = [np.asarray(full(jp, jb))]
        jl, jst = pre(jp, cut(jb, 0, s))
        out.append(np.asarray(jl))
        for i in range(s, s + n_dec):
            step = cut(jb, i, i + 1)
            jl, jst = dec(jp, jst, step["tokens"], {k: v for k, v in step.items() if k == "embeddings"})
            out.append(np.asarray(jl))
        outs.append(out)
    return outs


def port_run(tcfg, jtree, batch: dict, s: int, n_dec: int) -> list[np.ndarray]:
    """The port's outputs of :func:`jax_run` on JAX's tree, carried across
    by ``convert.lm_params_from_jax``."""
    tparams = convert.lm_params_from_jax(tcfg, jtree, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = [tt.forward_logits(tcfg, tparams, tb).numpy()]
    tl, tst = tt.prefill(tcfg, tparams, cut(tb, 0, s))
    out.append(tl.numpy())
    for i in range(s, s + n_dec):
        step = cut(tb, i, i + 1)
        tl, tst = tt.decode_step(tcfg, tparams, tst, step["tokens"],
                                 **{k: v for k, v in step.items() if k == "embeddings"})
        out.append(tl.numpy())
    return out


def run_both(jcfg, tcfg, jtree, batch: dict, s: int, n_dec: int):
    """Full-forward logits, prefill logits on the first s positions and
    n_dec teacher-forced decode steps, from JAX (jitted) and the port."""
    return jax_run(jcfg, [jtree], batch, s, n_dec)[0], port_run(tcfg, jtree, batch, s, n_dec)


def moved(jtree):
    """`jtree` with every weight scaled by (1 + MOVE * eps), eps standard
    normal from numpy's generator of seed 0, drawn leaf by leaf in
    :func:`flat_keys` order (computed in float64, rounded to the leaf's dtype)."""
    rng = np.random.default_rng(0)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        a = np.asarray(t)
        return (a.astype(np.float64) * (1 + MOVE * rng.standard_normal(a.shape))).astype(a.dtype)

    return walk(jtree)


def witness_moves(jcfg, jtree, batch: dict, s: int, n_dec: int):
    """JAX's outputs of :func:`jax_run` on `jtree`, and for each output the
    largest absolute move of JAX's own output when the weights are
    :func:`moved` by 1e-6 of themselves: the float32 conditioning of the
    function at this draw."""
    jout, jnear = jax_run(jcfg, [jtree, moved(jtree)], batch, s, n_dec)
    return jout, [float(np.abs(a - b).max()) for a, b in zip(jnear, jout)]


def check_within_witness(jout, tout, moves) -> None:
    """Every output's largest port-to-JAX distance is at most JAX's own
    move under the 1e-6 relative weight change (factor 1)."""
    for i, (j, t, mv) in enumerate(zip(jout, tout, moves)):
        assert t.shape == j.shape and np.isfinite(t).all(), i
        dist = float(np.abs(t - j).max())
        assert dist <= mv, f"output {i}: port-to-JAX {dist:.3e} > JAX's own 1e-6 move {mv:.3e}"


def draw_jax_params(archs, hashseed: int, path: Path) -> dict[str, dict]:
    """:func:`jax_params` of each arch as a process whose ``PYTHONHASHSEED``
    is `hashseed` draws them, made in such a subprocess and passed back as
    an ``.npz`` at `path`: a reproducible JAX weight draw."""
    code = "import sys, torch_lm_parity as m; m._save_draw(sys.argv[1], sys.argv[2:])"
    paths = [str(SRC), str(Path(__file__).parent), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths), PYTHONHASHSEED=str(hashseed),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code, str(path), *archs], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        def walk(spec, pre):  # the tree of JAX's param_specs, empty groups kept
            if isinstance(spec, dict):
                return {k: walk(v, f"{pre}{k}/") for k, v in spec.items()}
            return z[pre[:-1]]

        return {arch: walk(jparams_mod.param_specs(jget_smoke(arch)), f"{arch}:") for arch in archs}


def _save_draw(path: str, archs: list[str]) -> None:
    """This process's :func:`jax_params` of `archs` to an ``.npz``, keyed
    ``arch:`` + :func:`flat_keys` (the subprocess of :func:`draw_jax_params`)."""
    np.savez(path, **{f"{arch}:{k}": v for arch in archs
                      for k, v in zip(flat_keys(jax_params(arch)), jax.tree.leaves(jax_params(arch)))})


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
