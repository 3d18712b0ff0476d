"""The checks of the mesh tests (``test_torch_lm_mesh_*.py``) on one run of
``torch_lm_mesh_common``'s 4 ranks, against the JAX package's one-device
step and the port's, from the same fixed weights (the port's
``init_params`` of seed 0, carried to JAX by ``convert.jax_params_from_lm``):

* every parameter leaf on every rank is a ``DTensor`` with the placements
  of the rules' spec, and each rank's shard is, in shape and values, the
  addressable shard that JAX gives the same mesh position for that spec;
* the sharded ``loss_and_grads`` equals ``jax.value_and_grad`` of
  ``loss_fn`` within the one-device tolerances of
  ``tests/test_torch_lm_train_loss.py``: the loss within 1e-5, each
  gradient leaf within 1e-4 of its norm (1e-6 for a leaf whose gradient is
  analytically zero);
* 3 sharded AdamW steps equal the port's one-device steps on the same
  batches within the tolerances of ``tests/test_torch_lm_train_step.py``:
  each metric within 1e-4 (relative above 1; ``METRIC_RTOL`` for an arch
  whose step amplifies float32 rounding, with the witness of
  :func:`last_step_gradient`), params and moments within atol 2e-3 /
  rtol 1e-3;
* the greedy tokens of the sharded ``Server`` equal JAX's ``Server``'s;
  a row may differ only from a step where JAX's top-2 logit margin is
  below 1e-4 (a float32 near-tie), and not before;
* the 4-rank checkpoint holds the files of a one-device save of the same
  tree byte for byte (the manifest equal but for its write time), and JAX's
  ``CheckpointManager`` restores it exactly; rank 0 alone made host copies
  of the gathered leaves;
* the recurrent states of the served decode are ``DTensor``s laid out by
  ``transformer.decode_state_axes`` under the rules' ``batch`` rule.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_lm_mesh_common as common
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import serve as jserve
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.distributed import sharding as tsharding
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training import step as tstep
from repro_torch.training.step import make_train_step
from repro_torch.tree import tree_map
from torch_lm_parity import fixed_params, flat_keys, loss_and_grads_both

NEAR_TIE = 1e-4
#: the train metrics' tolerance (relative above 1) where it is not 1e-4: at
#: smoke width xlstm-1.3b's third step on the mesh tests' batches has a
#: gradient norm of ~1,010 (45.8 and 48.5 before it), and there its
#: gradient is ill-conditioned: at the same params, weights moved by 1e-6
#: of themselves move it as far as the 4 ranks' float32 rounding does
#: (:func:`last_step_gradient` holds that), and one-device runs from weights
#: moved by 1e-7 or 1e-6 of themselves read third-step norms 2.0% and 2.3%
#: apart (torch 2.13 on a CPU).  The loss, the params and the moments hold
#: to the shared tolerances
METRIC_RTOL = {"xlstm-1.3b": 2e-2}


def _ranks(out: Path, arch: str) -> list[dict]:
    return [json.loads((out / f"{arch}.rank{r}.json").read_text()) for r in range(common.WORLD)]


def _full(out: Path, arch: str) -> dict[str, np.ndarray]:
    with np.load(out / f"{arch}.full.npz") as z:
        return {k: z[k] for k in z.files}


def placements(out: Path, arch: str) -> None:
    cfg = tget_smoke(arch)
    shape = tuple(_ranks(out, arch)[0]["mesh"].values())
    mesh = tsharding.Mesh(np.array(["cpu"] * common.WORLD, dtype=object).reshape(shape),
                          ("data", "model"))
    rules = tsharding.ShardingRules(**common.RULES_KW)
    want = {k: [str(p) for p in rules.param_sharding(s.shape, s.axes, mesh).placements]
            for k, s in common.flat(pmod.param_specs(cfg))}
    sharded = set()
    for rec in _ranks(out, arch):
        assert rec["mesh"] == dict(zip(("data", "model"), shape))
        assert set(rec["leaves"]) == set(want)
        for key, leaf in rec["leaves"].items():
            assert leaf["type"] == "DTensor", (key, leaf)
            assert leaf["placements"] == want[key], (key, leaf["placements"], want[key])
            sharded.update(p for p in leaf["placements"] if p != "R")
        assert rec["opt_placements_equal_params"]
    # the layout shards over both axes: tensor parallel on model, FSDP on data
    assert any(p.startswith("S(") for p in sharded)


def shards(out: Path, jax_side: dict, arch: str) -> None:
    whole = dict(common.flat(pmod.init_params(tget_smoke(arch), 0, "cpu")))
    for rank, rec in enumerate(_ranks(out, arch)):
        with np.load(out / f"{arch}.local{rank}.npz") as z:
            local = {k: z[k] for k in z.files}
        for key, leaf in rec["leaves"].items():
            # the mesh holds the ranks in order: rank r is row-major position r
            sl = jax_side[arch][key]["slices"][rank]
            assert leaf["local_shape"] == [b - a for a, b in sl], (key, leaf["local_shape"], sl)
            want = whole[key].numpy()[tuple(slice(a, b) for a, b in sl)]
            np.testing.assert_array_equal(local[key], want, err_msg=key)


def loss_and_grads(out: Path, arch: str, variant: str | None = None) -> None:
    """The sharded loss and gradients against JAX's, of the smoke config or
    of its ``common.VARIANTS[variant]`` (the same fields on both sides)."""
    over = common.VARIANTS[variant] if variant else {}
    jc = dataclasses.replace(common.f32(jget_smoke(arch)), **over)
    tc = dataclasses.replace(common.f32(tget_smoke(arch)), **over)
    tree = fixed_params(arch)
    (jl, jm, jg), _ = loss_and_grads_both(jc, tc, tree, common.loss_batch(jc, variant))
    _hold_to(out, f"{arch}.{variant}" if variant else arch, tree, jl, jm, jg)


def jax_on_mesh(jax_dir: Path, arch: str, variant: str | None = None):
    """(loss, metrics, gradients in ``jax.tree.leaves`` order) of JAX's
    ``loss_fn`` under the same mesh (``common._JAX_MESH_LOSS``)."""
    with np.load(jax_dir / f"{arch}.{variant or 'base'}.jax.npz") as z:
        metrics = {k.split("/", 1)[1]: float(z[k]) for k in z.files if k.startswith("metric/")}
        n = sum(k.startswith("grad/") for k in z.files)
        return float(z["loss"]), metrics, [z[f"grad/{i}"] for i in range(n)]


def loss_and_grads_on_mesh(out: Path, jax_dir: Path, arch: str,
                           variant: str | None = None) -> None:
    """The sharded loss and gradients against JAX's under the same mesh
    (the MoE's "local" dispatch routes each batch shard on its own, with
    its own capacity and aux loss, so the one-device step is not its
    reference), within the tolerances of :func:`loss_and_grads`."""
    jl, jm, jg = jax_on_mesh(jax_dir, arch, variant)
    _hold_to(out, f"{arch}.{variant}" if variant else arch, fixed_params(arch), jl, jm, jg)


def _hold_to(out: Path, name: str, tree, jl: float, jm: dict, jg: list) -> None:
    full = _full(out, name)
    total = np.sqrt(sum(float(np.sum(np.square(g))) for g in jg))
    for rec in _ranks(out, name):
        assert np.isfinite(rec["loss"]) and abs(rec["loss"] - jl) <= 1e-5, (rec["loss"], jl)
        for k in ("ce", "aux", "tokens"):
            assert abs(rec["loss_metrics"][k] - jm[k]) <= 1e-5, k
    keys = flat_keys(tree)
    assert len(keys) == len(jg)
    for key, j in zip(keys, jg):
        t = full[f"grad/{key}"]
        assert t.shape == j.shape and np.isfinite(t).all(), key
        norm = float(np.linalg.norm(j))
        bound = 1e-4 * norm if norm >= 1e-5 * total else 1e-6
        assert float(np.abs(t - j).max()) <= bound, (key, float(np.abs(t - j).max()), norm)


def train_steps(out: Path, arch: str, per_shard: bool = False) -> None:
    """`per_shard`: the one-device run under a current mesh of the CPU in
    the ranks' shape, so that the MoE's "local" dispatch routes each batch
    shard on its own, as the ranks do (``moe._moe_ffn_local``)."""
    cfg = common.f32(tget_smoke(arch))
    params = pmod.init_params(cfg, 0, "cpu")
    opt = init_opt_state(params)
    step_fn = make_train_step(cfg, OptimizerConfig(**common.OPT))
    pipe = common.train_pipe(cfg)
    shape = tuple(_ranks(out, arch)[0]["mesh"].values())
    previous = tsharding.get_current_mesh()
    if per_shard:
        tsharding.set_current_mesh(tsharding.Mesh(
            np.array(["cpu"] * common.WORLD, dtype=object).reshape(shape), ("data", "model")))
    metrics = []
    try:
        for step in range(common.TRAIN_STEPS):
            params, opt, m = step_fn(params, opt, pipe.batch_at(step, "cpu"), step)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        tsharding.set_current_mesh(previous)
    rtol = METRIC_RTOL.get(arch, 1e-4)
    for rec in _ranks(out, arch):
        for got, want in zip(rec["train"], metrics, strict=True):
            assert set(got) == set(want)
            assert abs(got["loss"] - want["loss"]) <= 1e-4 * max(1.0, abs(want["loss"]))
            for k in want:
                assert abs(got[k] - want[k]) <= rtol * max(1.0, abs(want[k])), (k, got[k], want[k])
    full = _full(out, arch)
    for key, t in common.flat({"params": params, "opt": opt}):
        np.testing.assert_allclose(full[f"state/{key}"], t.numpy(), atol=2e-3, rtol=1e-3,
                                   err_msg=key)


def last_step_gradient(out: Path, arch: str, moved: float = 1e-6) -> dict[str, float]:
    """At the params the ranks held before their last train step, the
    ranks' loss and gradients of that step's batch against the one-device
    ones at the same params: the loss within 1e-5 (relative above 1), and
    the gradients no further from the one device's than twice what moving
    each weight by `moved` of itself (seeded normal draws) does to the
    one-device gradients.  That is the witness for ``METRIC_RTOL``: the 4
    ranks part from one device no more than rounding-scale changes do."""
    cfg = common.f32(tget_smoke(arch))
    with np.load(out / f"{arch}.last.npz") as z:
        got = {k: z[k] for k in z.files}
    keys = [k for k, _ in common.flat(pmod.param_specs(cfg))]
    like = pmod.init_params(cfg, 0, "cpu")
    batch = common.train_pipe(cfg).batch_at(common.TRAIN_STEPS - 1, "cpu")

    def one_device(scale) -> tuple[float, dict[str, np.ndarray]]:
        it = iter(torch.from_numpy(got[f"params/{k}"]) * scale(k) for k in keys)
        params = tree_map(lambda _: next(it), like)
        loss, _, grads = tstep.loss_and_grads(cfg, params, batch)
        return float(loss), {k: g.double().numpy() for k, g in common.flat(grads)}

    gen = torch.Generator().manual_seed(1)
    loss, want = one_device(lambda k: 1.0)
    _, near = one_device(lambda k: 1 + moved * torch.randn(got[f"params/{k}"].shape,
                                                           generator=gen))
    for rec in _ranks(out, arch):
        assert abs(rec["last_loss"] - loss) <= 1e-5 * max(1.0, abs(loss)), (rec["last_loss"], loss)

    def gap(g: dict) -> float:
        return float(np.sqrt(sum(np.sum(np.square(g[k] - want[k])) for k in want)))

    ranks = {k: got[f"grad/{k}"].astype(np.float64) for k in want}
    assert gap(ranks) <= 2 * gap(near), (gap(ranks), gap(near))
    return {"loss": loss, "norm": gap(dict.fromkeys(want, 0.0)), "ranks_gap": gap(ranks),
            "moved_gap": gap(near)}


def _jax_greedy(arch: str, prompts: np.ndarray, gen: int) -> tuple[np.ndarray, np.ndarray]:
    """JAX's ``Server`` greedy tokens and, at each step, its top-2 logit margin."""
    jc = common.f32(jget_smoke(arch))
    server = jserve.Server(jc, jax.tree.map(jnp.asarray, fixed_params(arch)), len(prompts),
                           jserve.ServerConfig())
    logits, state = server._prefill(server.params, {"tokens": jnp.asarray(prompts)})
    toks, margins = [], []
    for i in range(gen):
        if i:
            logits, state = server._decode(server.params, state, jnp.asarray(toks[-1])[:, None])
        lg = np.asarray(logits)
        top = np.sort(lg, axis=-1)
        margins.append(top[:, -1] - top[:, -2])
        toks.append(lg.argmax(-1).astype(np.int32))
    want = server.generate(prompts, gen)
    np.testing.assert_array_equal(np.stack(toks, 1), want)
    return want, np.stack(margins, 1)


def served_tokens(out: Path, arch: str) -> None:
    prompts = common.prompts(jget_smoke(arch).vocab_size)
    want, margins = _jax_greedy(arch, prompts, common.SERVE_GEN)
    recs = _ranks(out, arch)
    got = np.asarray(recs[0]["tokens"])
    for rec in recs[1:]:  # every rank samples the same tokens
        np.testing.assert_array_equal(np.asarray(rec["tokens"]), got)
    assert got.shape == want.shape
    for row in range(len(want)):
        diff = np.flatnonzero(got[row] != want[row])
        if len(diff):
            assert margins[row, diff[0]] < NEAR_TIE, (row, diff[0], margins[row, diff[0]])


def checkpoint(out: Path, arch: str, tmp_path: Path) -> None:
    full = _full(out, arch)
    tree: dict = {}
    for key, arr in full.items():
        if not key.startswith("state/"):
            continue
        node = tree
        *parents, last = key[len("state/"):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(arr)
    CheckpointManager(tmp_path / "one").save(common.TRAIN_STEPS, tree)
    mesh_dir = out / f"{arch}.ckpt" / f"step_{common.TRAIN_STEPS:09d}"
    one_dir = tmp_path / "one" / f"step_{common.TRAIN_STEPS:09d}"
    names = sorted(p.name for p in mesh_dir.iterdir())
    assert names == sorted(p.name for p in one_dir.iterdir())
    for name in names:
        if name == "manifest.json":
            a, b = (json.loads((d / name).read_text()) for d in (mesh_dir, one_dir))
            a.pop("time"), b.pop("time")
            assert a == b
        else:
            assert (mesh_dir / name).read_bytes() == (one_dir / name).read_bytes(), name
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), tree)
    restored = JManager(out / f"{arch}.ckpt").restore(common.TRAIN_STEPS, like)
    for key, arr in common.flat(restored):
        np.testing.assert_array_equal(np.asarray(arr), full[f"state/{key}"], err_msg=key)


def host_copies(out: Path, arch: str) -> None:
    """Rank 0 alone copies the gathered leaves to host memory, one copy a
    leaf; the other ranks hold none after the save."""
    n = sum(k.startswith("state/") for k in _full(out, arch))
    recs = _ranks(out, arch)
    assert recs[0]["host_copies"] == n > 0
    assert [r["host_copies"] for r in recs[1:]] == [0] * (common.WORLD - 1)


def zero_moments(out: Path, arch: str) -> None:
    """The AdamW step from moments sharded further than their parameters
    (ZeRO, the dry-run's layout) gives every rank the params of the step
    from moments laid out as the parameters, bit for bit."""
    for rec in _ranks(out, arch):
        assert rec["zero_layouts_differ"] > 0
        assert rec["zero_step_equal"]


def state_layouts(out: Path, arch: str) -> None:
    """Every leaf of the decode state after a prefill and a decode step on
    the ranks has the placements of ``decode_state_axes`` (the position, a
    replicated scalar, is a plain tensor on every rank)."""
    cfg = tget_smoke(arch)
    recs = _ranks(out, arch)
    shape = tuple(recs[0]["mesh"].values())
    mesh = tsharding.Mesh(np.array(["cpu"] * common.WORLD, dtype=object).reshape(shape),
                          ("data", "model"))
    rules = tsharding.ShardingRules()
    state = common.state_tree(transformer.init_decode_state(cfg, common.SERVE_SLOTS,
                                                            common.SERVE_PROMPT, device="meta"))
    axes = dict(common.flat(common.state_tree(transformer.decode_state_axes(cfg)),))
    for rec in recs:
        assert set(rec["state"]) == set(axes)
        for key, t in common.flat(state):
            got = rec["state"][key]
            if key == "pos":
                assert got["type"] == "Tensor" and got["shape"] == []
                continue
            want = [str(p) for p in rules.param_sharding(t.shape, axes[key], mesh).placements]
            assert got["type"] == "DTensor" and got["placements"] == want, (key, got, want)
            if key.endswith(("mixer/h", "mixer/c", "mixer/n", "mixer/m", "mixer/conv")):
                assert got["shape"] == list(t.shape), (key, got["shape"], list(t.shape))
