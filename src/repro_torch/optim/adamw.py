"""AdamW with decoupled weight decay, global-norm clipping, LR schedules.

The torch counterpart of ``repro.optim.adamw``, with its formulas (not
``torch.optim.AdamW``'s or ``clip_grad_norm_``'s: the clip scale here is
``min(1, max_norm / max(gn, 1e-9))``).  Optimizer state is a tree
mirroring params ({"m", "v"} float32 moments).

Semantics are the standard decoupled AdamW:
    m <- b1 m + (1-b1) g         v <- b2 v + (1-b2) g^2
    mhat = m / (1-b1^t)          vhat = v / (1-b2^t)
    p <- p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)
Weight decay is masked out for 1-D params (norms, biases, gates).

The learning rate and the bias corrections are float32 scalars computed
on the host (0-d CPU tensors), as JAX computes them in float32.
``adamw_step`` updates params, ``m`` and ``v`` in place (the counterpart
of JAX's donated buffers) and returns them.

On a mesh the leaves are ``DTensor``s.  The update is elementwise, so
each rank updates its own shards in the moments' layout: the gradient is
redistributed to it and the same formulas run on the local tensors (a
shard has its parameter's ndim, which decides the weight decay).  Where
the moments are laid out as the parameter (``init_opt_state``, the
launcher) the parameter's shards are updated in place; where they are
sharded further (the dry-run's ZeRO specs, ``launch.specs``) the
parameter is redistributed to their layout, updated, and put back.
``global_norm`` sums each leaf's squares over its shards
(DTensor reduces them across ranks), so the clip scale is the
one-device value.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # "cosine" | "constant" | "linear"
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Schedule value at `step` (an int or a 0-d tensor), a float32 0-d
    CPU tensor."""
    step = _f32(int(step))
    if cfg.warmup_steps > 0:
        warm = torch.clamp(step / cfg.warmup_steps, max=1.0)
    else:
        warm = _f32(1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        decay = _f32(1.0)
    elif cfg.schedule == "linear":
        frac = torch.clamp((step - cfg.warmup_steps) / span, 0, 1)
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    else:  # cosine
        frac = torch.clamp((step - cfg.warmup_steps) / span, 0, 1)
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def init_opt_state(params: Tree) -> Tree:
    """float32 zero moments, each laid out as its parameter."""

    def zeros(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree: Tree) -> torch.Tensor:
    """The 2-norm of every leaf together; over ``DTensor`` leaves a
    replicated 0-d ``DTensor`` (each leaf's sum of squares reduced across
    its shards)."""
    return torch.sqrt(sum(_sumsq(x) for x in tree_leaves(tree)))


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(x.float()))
    if is_dtensor(s):
        from torch.distributed.tensor import Replicate

        s = s.redistribute(s.device_mesh, [Replicate()] * s.device_mesh.ndim)
    return s


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    """Scale `grads` in place by ``min(1, max_norm / max(gn, 1e-9))``, the
    scale computed on the gradients' device (no host read); returns
    (grads, gn)."""
    gn = global_norm(grads)
    scale = torch.clamp(torch.full_like(gn, max_norm) / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


@torch.no_grad()
def adamw_step(
    cfg: OptimizerConfig,
    params: Tree,
    grads: Tree,
    opt_state: Tree,
    step,
) -> tuple[Tree, Tree, torch.Tensor]:
    """One AdamW update, in place.  Returns (params, opt_state, lr)."""
    lr = lr_at(cfg, step)
    t = _f32(int(step)) + 1.0
    bc1 = float(1.0 - cfg.b1**t)
    bc2 = float(1.0 - cfg.b2**t)
    lr_f = float(lr)
    flat = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["m"]),
               tree_leaves(opt_state["v"]))
    # ``a.add_(b, alpha=c)`` rounds a + c * b once, as XLA's fused
    # multiply-add does for JAX's ``c * b + a``.
    for p, g, m, v in flat:
        if not is_dtensor(p):
            _update(cfg, p, g, m, v, bc1, bc2, lr_f)
            continue
        # each rank updates its shards in the moments' layout (v shares m's)
        mesh, layout = m.device_mesh, m.placements
        g_l, m_l, v_l = g.redistribute(mesh, layout).to_local(), m.to_local(), v.to_local()
        if p.placements == layout:  # as init_opt_state lays them out
            _update(cfg, p.to_local(), g_l, m_l, v_l, bc1, bc2, lr_f)
            continue
        # ZeRO moments (the dry-run's specs): p updated in their layout, then put back
        from torch.distributed.tensor import DTensor

        p_l = p.redistribute(mesh, layout).to_local().clone()
        _update(cfg, p_l, g_l, m_l, v_l, bc1, bc2, lr_f)
        new = DTensor.from_local(p_l, mesh, layout, run_check=False, shape=p.shape,
                                 stride=p.stride())
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
    return params, opt_state, lr


def _update(cfg, p, g, m, v, bc1: float, bc2: float, lr_f: float) -> None:
    gf = g.float()
    torch.add(gf * (1 - cfg.b1), m, alpha=cfg.b1, out=m)
    torch.add(gf * (1 - cfg.b2) * gf, v, alpha=cfg.b2, out=v)
    delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    if p.ndim >= 2 and cfg.weight_decay:
        delta.add_(p.float(), alpha=cfg.weight_decay)
    if p.dtype == torch.float32:
        p.add_(delta, alpha=-lr_f)
    else:
        p.copy_(p.float().add_(delta, alpha=-lr_f))
