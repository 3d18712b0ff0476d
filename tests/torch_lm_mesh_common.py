"""The mesh tests' ranks (``test_torch_lm_mesh_*.py``): one run of the port's
sharded LM step on 4 gloo processes, and the helpers that read it back.

Run as a script under ``python -m torch.distributed.run --standalone
--nproc-per-node 4`` it starts the gloo group (``launch.mesh.init_distributed``),
builds the (2, 2) ``data x model`` mesh of the group's ranks
(``mesh_for(model_parallel=2)``; ``--model-parallel 4``: the (1, 4) mesh, on
which qwen3-0.6b's 2 kv heads do not divide ``model`` and its wk and wv are
sharded on their head_dim), and for each arch given, at smoke width in
float32 compute, from the port's seed-0 weights laid out by ``RULES_KW``:

* writes each rank's leaves (type, placements, local shape, local values);
* runs ``loss_and_grads`` on ``batch_for(cfg, 2, 16, seed=1)`` (the batch of
  ``tests/test_torch_lm_train_loss.py``) and writes the loss and the whole
  gradients;
* takes 3 ``make_train_step`` steps on ``TokenPipeline`` batches laid out by
  ``data_sharding``, and the first once more from moments laid out as ZeRO
  lays them out (over ``data`` where the parameter is not), and writes the
  losses, whether the two first steps agree, the whole params and moments, and
  a checkpoint of them through ``CheckpointManager`` (every rank gathers,
  rank 0 writes), counting each rank's host copies of a leaf;
* serves 4 prompts greedily through ``launch.serve.Server`` and writes the
  tokens (the archs on token input alone: musicgen-medium and
  llama-3.2-vision-90b fail at the prefill in both packages' ``Server``);
  for the recurrent archs it also writes the type, shape and placements of
  each leaf of the decode state after a prefill and one decode step;
* with ``--variant NAME`` (one or more), runs ``loss_and_grads`` once more
  with the config fields of ``VARIANTS[NAME]``, on ``loss_batch(cfg, NAME)``,
  and writes it as ``<arch>.<NAME>``: the per-block remat under the "dots"
  policy, the online-softmax blocked attention with 8-wide blocks (some
  wholly masked), the MoE's capacity drops on its local and its gspmd
  dispatch (a batch whose shards route 64 tokens each, past the capacity
  floor of 16) beside the dropless dispatch of the same batch, and the
  layouts that do not divide a ``model`` axis of 4 (6 experts; 6 query
  heads, 2 kv heads and head_dim 6; the same heads with head_dim 8, which
  divides it), whose weights are drawn for the variant's shapes
  (:func:`variant_params`).

``RULES_KW`` makes ``ShardingRules(fsdp=True)`` with an FSDP threshold of 4 KiB
(in float32), so that at smoke width the weight matrices are sharded over
``data`` as well as ``model``; the norm scales (256 bytes) stay whole.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
WORLD = 4
MESH_SHAPE = (2, 2)
RULES_KW = dict(fsdp=True, fsdp_min_bytes=1 << 12)
OPT = dict(warmup_steps=2, total_steps=10)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 32, 3
#: archs whose ranks also write, before the last train step, the params and
#: the whole gradients of that step's batch (``<arch>.last.npz``), for
#: ``torch_lm_mesh_checks.last_step_gradient``
LAST_STEP_GRADS = ("xlstm-1.3b",)
SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN = 4, 8, 6
#: config fields of the loss-and-gradient variants (``--variant``)
VARIANTS = {
    "remat_dots": dict(remat=True, remat_policy="dots"),
    "blocked": dict(attn_block_threshold=16, attn_block_q=8, attn_block_kv=8),
    "drops": dict(moe_capacity=0.5),
    "drops_gspmd": dict(moe_capacity=0.5, moe_impl="gspmd"),
    "dropless_wide": dict(),
    "experts6": dict(moe_experts=6),
    "heads6": dict(n_heads=6, n_kv_heads=2, head_dim=6),
    "heads6_hd8": dict(n_heads=6, n_kv_heads=2, head_dim=8),
}
#: the (batch, seq) of a variant's loss batch where it is not ``loss_batch``'s (2, 16)
VARIANT_BATCH = {"drops": (4, 32), "drops_gspmd": (4, 32), "dropless_wide": (4, 32)}


def f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(2, vocab, (SERVE_SLOTS, SERVE_PROMPT)).astype(np.int32)


def loss_batch(cfg, variant: str | None = None) -> dict[str, np.ndarray]:
    """The tokens and, for the stub frontends, the frame embeddings or the
    context (``tests/torch_lm_parity.batch_for``'s draws)."""
    rng = np.random.default_rng(1)
    b, s = VARIANT_BATCH.get(variant, (2, 16))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.n_ctx_tokens:
        out["ctx"] = rng.standard_normal((b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return out


def serves(cfg) -> bool:
    """Whether ``launch.serve.Server`` serves the arch (token input, no context)."""
    return cfg.input_mode == "tokens" and not cfg.n_ctx_tokens


def recurrent(cfg) -> bool:
    return bool({"rec", "mlstm", "slstm"} & set(cfg.layer_pattern + cfg.tail_pattern))


def train_pipe(cfg):
    """The ``TokenPipeline`` of the train steps (with the stub frontends' draws)."""
    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models.config import ShapeConfig

    return pipeline_for(cfg, ShapeConfig("mesh", TRAIN_SEQ, TRAIN_BATCH, "train"), seed=0)


def variant_config(cfg, variant: str | None):
    return dataclasses.replace(cfg, **VARIANTS.get(variant, {}))


def variant_params(arch: str, variant: str | None):
    """The port's seed-0 smoke weights of `arch` as JAX's numpy tree, drawn
    for the shapes of ``VARIANTS[variant]`` where it changes them."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import params as pmod
    from torch_lm_parity import fixed_params

    cfg = get_smoke_config(arch)
    vcfg = variant_config(cfg, variant)
    if pmod.param_specs(vcfg) == pmod.param_specs(cfg):
        return fixed_params(arch)
    return convert.jax_params_from_lm(pmod.init_params(vcfg, 0, "cpu"))


def state_tree(state) -> dict:
    """A decode state as a dict tree (its ``tail`` list keyed by index)."""
    if isinstance(state, list):
        return {str(i): state_tree(v) for i, v in enumerate(state)}
    if isinstance(state, dict):
        return {k: state_tree(v) for k, v in state.items()}
    return state


def flat(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key, leaf) in sorted-key order, keys joined with "/"."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def mesh_shape(model_parallel: int) -> tuple[int, int]:
    return WORLD // model_parallel, model_parallel


#: the environment variable that names a directory of ranks' files made
#: elsewhere (for example under another torch, on 4 gloo ranks of another
#: machine's CPU): this script run with the archs, ``--model-parallel`` and
#: ``--variant`` of a test module's :func:`start_ranks` call and ``--out-root
#: DIR``.  Where it is set, the tests read those files instead of starting
#: the ranks, and hold them with their own checks.
RANKS_FROM = "LM_MESH_RANKS_FROM"


def ranks_key(archs: list[str], model_parallel: int, variants: list[str]) -> str:
    """The subdirectory of ``--out-root`` that a run with these arguments writes."""
    return "__".join(["+".join(archs), f"mp{model_parallel}", *variants])


def start_ranks(archs: list[str], out: Path, *, model_parallel: int = MESH_SHAPE[1],
                variant: str | list[str] | None = None) -> subprocess.Popen | Path:
    """Start this script on 4 gloo ranks; :func:`ranks_done` waits for it.
    Under ``RANKS_FROM`` nothing starts: the run's files are read from that
    directory (:func:`ranks_key`)."""
    variants = [variant] if isinstance(variant, str) else list(variant or [])
    if os.environ.get(RANKS_FROM):
        return Path(os.environ[RANKS_FROM]) / ranks_key(archs, model_parallel, variants)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    # at a lower priority (nice 10): the 4 ranks yield the cores to the
    # suite's other workers, some of whose tests time short windows
    cmd = ["nice", "-n", "10", sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={WORLD}", __file__, "--out", str(out),
           "--model-parallel", str(model_parallel), *archs]
    for v in variants:
        cmd += ["--variant", v]
    return subprocess.Popen(cmd, env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def ranks_done(proc: subprocess.Popen | Path, out: Path, timeout: int = 600) -> Path:
    if isinstance(proc, Path):  # made elsewhere (RANKS_FROM)
        assert any(proc.glob("*.rank0.json")), f"no ranks' files in {proc}"
        return proc
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def _worker(archs: list[str], out: Path, model_parallel: int, variants: list[str]) -> None:
    import torch

    torch.set_num_threads(1)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import ShardingRules, is_dtensor, tree_param_shardings
    from repro_torch.launch.mesh import init_distributed, mesh_for
    from repro_torch.launch.serve import Server, ServerConfig
    from repro_torch.models import params as pmod
    from repro_torch.models import transformer
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.training.step import loss_and_grads, make_train_step
    from repro_torch.tree import tree_map

    init_distributed("cpu")
    rank = torch.distributed.get_rank()
    mesh = mesh_for(model_parallel=model_parallel)
    assert mesh.shape == dict(zip(("data", "model"), mesh_shape(model_parallel))), mesh
    rules = ShardingRules(**RULES_KW)
    full = lambda t: t.full_tensor() if is_dtensor(t) else t  # noqa: E731
    out.mkdir(parents=True, exist_ok=True)

    for arch in archs:
        cfg = f32(get_smoke_config(arch))
        rec: dict = {"rank": rank, "mesh": mesh.shape}
        params = pmod.init_params(cfg, 0, mesh=mesh, rules=rules)
        leaves = flat(params)
        rec["leaves"] = {k: {"type": type(t).__name__,
                             "placements": [str(p) for p in t.placements] if is_dtensor(t) else None,
                             "local_shape": list(t.to_local().shape if is_dtensor(t) else t.shape)}
                         for k, t in leaves}
        np.savez(out / f"{arch}.local{rank}.npz",
                 **{k: (t.to_local() if is_dtensor(t) else t).numpy() for k, t in leaves})

        batch = {k: rules.data_sharding(mesh, v.ndim).place(torch.from_numpy(v))
                 for k, v in loss_batch(cfg).items()}
        loss, metrics, grads = loss_and_grads(cfg, params, batch)
        arrays = {f"grad/{k}": full(g).numpy() for k, g in flat(grads)}
        rec["loss"] = float(full(loss))
        rec["loss_metrics"] = {k: float(full(v)) for k, v in metrics.items()}
        for variant in variants:
            vcfg = variant_config(cfg, variant)
            vbatch = {k: rules.data_sharding(mesh, v.ndim).place(torch.from_numpy(v))
                      for k, v in loss_batch(cfg, variant).items()}
            vparams = (params if pmod.param_specs(vcfg) == pmod.param_specs(cfg)
                       else pmod.init_params(vcfg, 0, mesh=mesh, rules=rules))
            vloss, vmetrics, vgrads = loss_and_grads(vcfg, vparams, vbatch)
            vrec = {"loss": float(full(vloss)),
                    "loss_metrics": {k: float(full(v)) for k, v in vmetrics.items()}}
            vgrads = {f"grad/{k}": full(g).numpy() for k, g in flat(vgrads)}
            if rank == 0:
                np.savez(out / f"{arch}.{variant}.full.npz", **vgrads)
            (out / f"{arch}.{variant}.rank{rank}.json").write_text(json.dumps(vrec))

        step_fn = make_train_step(cfg, OptimizerConfig(**OPT))
        opt = init_opt_state(params)
        pipe = train_pipe(cfg)
        rec["train"] = []
        for step in range(TRAIN_STEPS):
            if step == TRAIN_STEPS - 1 and arch in LAST_STEP_GRADS:
                last_loss, _, last = loss_and_grads(cfg, params,
                                                    pipe.sharded_batch_at(step, mesh, rules))
                rec["last_loss"] = float(full(last_loss))
                last_arrays = {**{f"params/{k}": full(t).numpy() for k, t in flat(params)},
                               **{f"grad/{k}": full(g).numpy() for k, g in flat(last)}}
                if rank == 0:
                    np.savez(out / f"{arch}.last.npz", **last_arrays)
            params, opt, m = step_fn(params, opt, pipe.sharded_batch_at(step, mesh, rules), step)
            rec["train"].append({k: float(v) for k, v in m.items()})
            if step == 0:
                first = {k: full(t).clone() for k, t in flat(params)}
        # the first step once more, the moments laid out as ZeRO lays them out
        # (every leaf over data, as the dry-run's specs): the same params
        zparams = pmod.init_params(cfg, 0, mesh=mesh, rules=rules)
        zero = tree_param_shardings(mesh, pmod.param_specs(cfg), pmod.spec_tree_axes(cfg),
                                    dataclasses.replace(rules, fsdp_min_bytes=0))
        zopt = {k: tree_map(lambda t, s: t.redistribute(t.device_mesh, s.placements), v, zero)
                for k, v in init_opt_state(zparams).items()}
        rec["zero_layouts_differ"] = sum(a.placements != b.placements for (_, a), (_, b)
                                         in zip(flat(zparams), flat(zopt["m"])))
        zparams, zopt, _ = step_fn(zparams, zopt, pipe.sharded_batch_at(0, mesh, rules), 0)
        rec["zero_step_equal"] = all(torch.equal(full(t), first[k]) for k, t in flat(zparams))
        state = {"params": params, "opt": opt}
        arrays.update({f"state/{k}": full(t).numpy() for k, t in flat(state)})
        rec["opt_placements_equal_params"] = all(
            tuple(a.placements) == tuple(b.placements)
            for (_, a), (_, b) in zip(flat(params), flat(opt["m"])))
        copies = []
        host = ckpt_manager._host
        ckpt_manager._host = lambda leaf: copies.append(1) or host(leaf)  # noqa: E731
        try:
            CheckpointManager(out / f"{arch}.ckpt").save(TRAIN_STEPS, state)
        finally:
            ckpt_manager._host = host
        rec["host_copies"] = len(copies)

        if serves(cfg):
            server = Server(cfg, pmod.init_params(cfg, 0, mesh=mesh, rules=rules), SERVE_SLOTS,
                            ServerConfig())
            rec["tokens"] = server.generate(prompts(cfg.vocab_size), SERVE_GEN).tolist()
        if serves(cfg) and recurrent(cfg):
            toks = torch.as_tensor(prompts(cfg.vocab_size))
            _, state = transformer.prefill(cfg, server.params, {"tokens": server._place(toks)})
            _, state = transformer.decode_step(cfg, server.params, state,
                                               server._place(toks[:, -1:]))
            rec["state"] = {k: {"type": type(t).__name__, "shape": list(t.shape),
                                "placements": [str(p) for p in t.placements] if is_dtensor(t)
                                else None}
                            for k, t in flat(state_tree(state))}

        if rank == 0:
            np.savez(out / f"{arch}.full.npz", **arrays)
        (out / f"{arch}.rank{rank}.json").write_text(json.dumps(rec))

    torch.distributed.destroy_process_group()


#: JAX's addressable shard of every parameter leaf on a (2, 2) mesh of 4 forced
#: host devices under the same rules: the index slices of each mesh position
_JAX_SHARDS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import jax
from repro.configs import get_smoke_config
from repro.distributed import sharding
from repro.models import params as pmod
mesh = jax.make_mesh({shape!r}, ("data", "model"))
rules = sharding.ShardingRules(**{rules!r})
out = {{}}
for arch in {archs!r}:
    cfg = get_smoke_config(arch)
    specs = pmod.param_specs(cfg)
    def walk(tree, prefix):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
                continue
            sh = rules.param_sharding(v.shape, v.axes, mesh)
            where = sh.devices_indices_map(tuple(v.shape))
            pos = []
            for idx in [(i, j) for i in range({shape!r}[0]) for j in range({shape!r}[1])]:
                sl = where[mesh.devices[idx]]
                pos.append([[s.start or 0, v.shape[d] if s.stop is None else s.stop]
                            for d, s in enumerate(sl)])
            out.setdefault(arch, {{}})[prefix + k] = {{"spec": [list(e) if isinstance(e, tuple) else e
                                                      for e in tuple(sh.spec)], "slices": pos}}
    walk(specs, "")
print("RESULT", json.dumps(out))
"""


#: JAX's ``loss_fn`` value and gradients under the same mesh and rules (JAX's
#: ``moe_ffn`` reads the current mesh: its "local" dispatch runs the
#: ``shard_map`` with the two all-to-alls), from the port's seed-0 weights
#: (``variant_params``), for each (arch, variant) case, written to
#: ``<arch>.<variant>.jax.npz``
_JAX_MESH_LOSS = """
import dataclasses
import jax.numpy as jnp
import numpy as np
from pathlib import Path
from repro.launch.mesh import _make_mesh
from repro.models import transformer
import torch_lm_mesh_common as common
lmesh = _make_mesh({shape!r}, ("data", "model"))
sharding.set_current_mesh(lmesh)
for arch, variant in {cases!r}:
    cfg = common.variant_config(common.f32(get_smoke_config(arch)), variant)
    leaves, treedef = jax.tree.flatten(jax.tree.map(jnp.asarray, common.variant_params(arch, variant)))
    specs = jax.tree.leaves(pmod.param_specs(cfg), is_leaf=lambda v: isinstance(v, pmod.ParamSpec))
    params = treedef.unflatten([jax.device_put(a, rules.param_sharding(s.shape, s.axes, lmesh))
                                for a, s in zip(leaves, specs)])
    batch = {{k: jax.device_put(jnp.asarray(v), rules.data_sharding(lmesh, v.ndim))
             for k, v in common.loss_batch(cfg, variant).items()}}
    vg = jax.jit(jax.value_and_grad(lambda p, b: transformer.loss_fn(cfg, p, b), has_aux=True))
    with lmesh:
        (loss, metrics), grads = vg(params, batch)
    np.savez(Path({out!r}) / f"{{arch}}.{{variant or 'base'}}.jax.npz", loss=np.asarray(loss),
             **{{f"metric/{{k}}": np.asarray(v) for k, v in metrics.items()}},
             **{{f"grad/{{i}}": np.asarray(g) for i, g in enumerate(jax.tree.leaves(grads))}})
print("LOSSES", len({cases!r}))
"""


def start_jax_shards(archs: list[str], shape: tuple[int, int] = MESH_SHAPE, *,
                     loss_cases: list[tuple[str, str | None]] = (),
                     out: Path | None = None) -> subprocess.Popen:
    """JAX's shard slices of `archs`' parameters on a `shape` mesh, in a
    subprocess (4 forced host devices); read them with :func:`jax_shards`.
    With `loss_cases`, (arch, variant) pairs (None: the smoke config), it
    also writes JAX's loss and gradients of each under that mesh into `out`
    (``_JAX_MESH_LOSS``)."""
    env = {"PYTHONPATH": f"{SRC}:{ROOT / 'tests'}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    code = _JAX_SHARDS.format(shape=tuple(shape), rules=RULES_KW, archs=list(archs))
    if loss_cases:
        code += _JAX_MESH_LOSS.format(shape=tuple(shape), cases=list(loss_cases), out=str(out))
    # at nice 10, as the ranks: the suite's other workers keep their share of the cores
    return subprocess.Popen(["nice", "-n", "10", sys.executable, "-c", code], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def jax_shards(proc: subprocess.Popen) -> dict:
    stdout, stderr = proc.communicate(timeout=600)
    line = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
    assert line and proc.returncode == 0, stderr[-3000:]
    return json.loads(line[0][len("RESULT "):])


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*")
    where = ap.add_mutually_exclusive_group(required=True)
    where.add_argument("--out")
    where.add_argument("--out-root", help="write to OUT_ROOT/<ranks_key> (RANKS_FROM)")
    ap.add_argument("--model-parallel", type=int, default=MESH_SHAPE[1])
    ap.add_argument("--variant", choices=sorted(VARIANTS), action="append", default=[])
    a = ap.parse_args()
    out = Path(a.out) if a.out else Path(a.out_root) / ranks_key(a.archs, a.model_parallel,
                                                                 a.variant)
    _worker(a.archs, out, a.model_parallel, a.variant)
