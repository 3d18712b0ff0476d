"""Training launcher: checkpointed, preemptible, resumable.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b   # full width, on the card

The torch counterpart of ``repro.launch.train``, with its flags (plus
``--device``: the card by default, which raises without one unless
``--device cpu`` is given), its loop, log lines, checkpoint cadence and
resume:
  * the mesh of the devices present (``mesh_for``; on one card or the
    CPU a (1, 1) mesh) or the production mesh (``--production``);
    parameters are placed by the sharding rules, which hold a tree on one
    device (a mesh of several cards raises, ROADMAP "Blocked on
    hardware");
  * deterministic step-keyed data (resume == identical batches);
  * async atomic checkpoints every --ckpt-every steps, and SIGTERM
    flushes the last completed step and exits 0;
  * resume: picks up the latest checkpoint under --ckpt-dir.

The step updates params and optimizer state in place, so each step runs
inside the SIGTERM handler's ``hold()``: a SIGTERM during a step is
served when the step has completed, and the checkpoint it writes holds
that step's state whole.  There is no ``--compress`` flag (nor in JAX's
launcher): ``repro_torch.distributed.compress`` is a library.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, install_sigterm_handler
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.hdc_model import resolve_device
from repro_torch.data.tokens import pipeline_for
from repro_torch.distributed.sharding import (
    ShardingRules,
    get_current_mesh,
    set_current_mesh,
    tree_param_shardings,
)
from repro_torch.launch.mesh import describe, make_production_mesh, mesh_for
from repro_torch.models import params as pmod
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training.step import make_train_step
from repro_torch.tree import tree_map


def main(argv=None, *, on_step=None) -> int:
    """Train; `on_step(step, params, opt_state, metrics)`, where given, is
    called after each step (a measurement hook)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    devices = [dev] if dev.type == "cpu" else None
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    mesh = (
        make_production_mesh(devices=devices)
        if args.production
        else mesh_for(model_parallel=args.model_parallel, devices=devices)
    )
    previous = get_current_mesh()
    set_current_mesh(mesh)
    guard = None
    try:
        rules = ShardingRules(fsdp=cfg.fsdp)
        print(f"training {cfg.name} on {describe(mesh)}; {cfg.n_params():,} params", flush=True)

        opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps)
        step_fn = make_train_step(cfg, opt_cfg)
        shardings = tree_param_shardings(mesh, pmod.param_specs(cfg), pmod.spec_tree_axes(cfg), rules)
        params = tree_map(lambda p, s: s.place(p), pmod.init_params(cfg, args.seed, "cpu"), shardings)
        opt_state = init_opt_state(params)

        start_step = 0
        mgr = None
        if args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir)
            latest = mgr.latest_step()
            if latest is not None:
                print(f"resuming from step {latest}", flush=True)
                state = {"params": params, "opt": opt_state}
                restored = mgr.restore(latest, state)
                tree_map(lambda t, a: t.copy_(torch.as_tensor(a)), state, restored)
                start_step = latest

            live = {"step": start_step}

            def flush():  # SIGTERM preemption hook
                mgr.wait()
                mgr.save(int(live["step"]), {"params": params, "opt": opt_state})

            guard = install_sigterm_handler(flush)

        pipe = pipeline_for(cfg, shape, seed=args.seed)
        data_dev = rules.data_sharding(mesh).device
        losses = []
        t0 = time.time()
        for step in range(start_step, args.steps):
            with guard.hold() if guard else contextlib.nullcontext():
                batch = pipe.batch_at(step, data_dev)
                params, opt_state, metrics = step_fn(params, opt_state, batch, step)
                losses.append(float(metrics["loss"]))
                if on_step is not None:
                    on_step(step, params, opt_state, metrics)
                if mgr:
                    live["step"] = step + 1
                if step % args.log_every == 0 or step == args.steps - 1:
                    dt = time.time() - t0
                    print(
                        f"step {step:5d} loss {losses[-1]:.4f} "
                        f"gnorm {float(metrics['grad_norm']):.3f} "
                        f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)",
                        flush=True,
                    )
                if mgr and (step + 1) % args.ckpt_every == 0:
                    mgr.save(step + 1, {"params": params, "opt": opt_state}, blocking=False)
        if mgr:
            mgr.wait()
            mgr.save(args.steps, {"params": params, "opt": opt_state})
    finally:
        if guard is not None:
            guard.close()
        set_current_mesh(previous)
    print(f"final loss {np.mean(losses[-5:]):.4f} (first {np.mean(losses[:5]):.4f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
