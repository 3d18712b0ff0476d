"""Training launcher: checkpointed, preemptible, resumable.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b   # full width, on the card
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen3-0.6b --smoke --model-parallel 2 --device cpu

The torch counterpart of ``repro.launch.train``, with its flags (plus
``--device``: the card by default, which raises without one unless
``--device cpu`` is given), its loop, log lines, checkpoint cadence and
resume:
  * the mesh of the devices present (``mesh_for``; on one card or the
    CPU a (1, 1) mesh) or the production mesh (``--production``);
    parameters and optimizer state are placed by the sharding rules
    (``ShardingRules(fsdp=cfg.fsdp)``, as JAX's launcher);
  * under ``python -m torch.distributed.run`` one process a card
    (NCCL; gloo with ``--device cpu``): the mesh is the group's ranks,
    params and ``m``/``v`` are ``DTensor``s, each step's batch is laid
    out by ``data_sharding`` (each rank holds its rows), checkpoints
    gather to rank 0's files, and rank 0 alone prints;
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
import torch.distributed

from repro_torch.checkpoint import CheckpointManager, install_sigterm_handler
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.hdc_model import resolve_device
from repro_torch.data.tokens import pipeline_for
from repro_torch.distributed.sharding import (
    ShardingRules,
    get_current_mesh,
    set_current_mesh,
)
from repro_torch.launch.mesh import (
    describe,
    group_up,
    init_distributed,
    make_production_mesh,
    mesh_for,
)
from repro_torch.models import params as pmod
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training.step import make_train_step
from repro_torch.tree import tree_map


class StepClock:
    """Milliseconds between consecutive ticks: CUDA events on a card (the
    device's time line), the host's clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: list = []

    def tick(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def leaf_layouts(tree) -> dict[str, dict]:
    """Each leaf's type, global and local shape and (DTensor) placements."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.distributed.sharding import is_dtensor

    out = {}
    for key, t in _flatten(tree):
        d = is_dtensor(t)
        out[key] = {"type": type(t).__name__, "shape": list(t.shape),
                    "local_shape": list(t.to_local().shape if d else t.shape),
                    "placements": [str(p) for p in t.placements] if d else None}
    return out


def write_metrics(path: str, dev: torch.device, mesh, fields: dict) -> None:
    """``<path>.rank<r>.json``: `fields`, the rank, the mesh and the peak
    device memory of this process."""
    import json
    from pathlib import Path

    rank = torch.distributed.get_rank() if mesh.distributed else 0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    rec = {"rank": rank, "world": mesh.size, "mesh": mesh.shape, "device": str(dev),
           "max_memory_allocated": peak, **fields}
    out = Path(f"{path}.rank{rank}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec))


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
    ap.add_argument("--metrics-out", default=None,
                    help="write each rank's losses, step ms, peak memory and leaf layouts "
                         "to <path>.rank<r>.json")
    args = ap.parse_args(argv)

    started = not group_up()
    group_dev = init_distributed(args.device)  # None outside torchrun
    dev = group_dev or resolve_device(args.device)
    devices = [dev] if dev.type == "cpu" and group_dev is None else None
    rank0 = group_dev is None or torch.distributed.get_rank() == 0

    def say(line: str) -> None:
        if rank0:
            print(line, flush=True)

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
        say(f"training {cfg.name} on {describe(mesh)}; {cfg.n_params():,} params")

        opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps)
        step_fn = make_train_step(cfg, opt_cfg)
        params = pmod.init_params(cfg, args.seed, mesh=mesh, rules=rules)
        opt_state = init_opt_state(params)

        start_step = 0
        mgr = None
        if args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir)
            latest = mgr.latest_step()
            if latest is not None:
                say(f"resuming from step {latest}")
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
        losses = []
        clock = StepClock(dev)
        t0 = time.time()
        for step in range(start_step, args.steps):
            with guard.hold() if guard else contextlib.nullcontext():
                batch = pipe.sharded_batch_at(step, mesh, rules)
                params, opt_state, metrics = step_fn(params, opt_state, batch, step)
                losses.append(float(metrics["loss"]))
                clock.tick()
                if on_step is not None:
                    on_step(step, params, opt_state, metrics)
                if mgr:
                    live["step"] = step + 1
                if step % args.log_every == 0 or step == args.steps - 1:
                    dt = time.time() - t0
                    say(
                        f"step {step:5d} loss {losses[-1]:.4f} "
                        f"gnorm {float(metrics['grad_norm']):.3f} "
                        f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)"
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
    say(f"final loss {np.mean(losses[-5:]):.4f} (first {np.mean(losses[:5]):.4f})")
    if args.metrics_out:
        write_metrics(args.metrics_out, dev, mesh, {
            "arch": cfg.name, "batch": args.batch, "seq": args.seq, "start_step": start_step,
            "losses": losses, "step_ms": clock.ms(),
            "leaves": leaf_layouts({"params": params, "opt": opt_state})})
    if group_dev is not None and started:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
