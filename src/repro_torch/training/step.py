"""The training step: loss -> grads -> clip -> AdamW (+ grad accumulation).

The torch counterpart of ``repro.training.step``.  `make_train_step`
returns train_step(params, opt_state, batch, step), which runs the
forward under autograd, sums the microbatches' float32 gradients when
accumulating (a sequential loop: activation memory / accum), clips them
and updates params, ``m`` and ``v`` in place (the counterpart of JAX's
donated buffers).

On a mesh (one process a card) params, optimizer state and batch are
``DTensor``s placed by the sharding rules, and the step runs on them as
it is, forward, backward and update, under ``sharding.mesh_ops``; its
metrics come back as plain 0-d tensors, the same on every rank.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed.sharding import is_dtensor, mesh_ops
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, adamw_step, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


def loss_and_grads(cfg: ModelConfig, params: Tree, batch: Tree) -> tuple[torch.Tensor, Tree, Tree]:
    """(loss, loss_fn's metrics, grads) of one batch; `params` is left as
    it was.  The gradient of a leaf the loss does not use is zero, as
    ``jax.grad`` gives it."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with mesh_ops(params), torch.enable_grad():
        loss, metrics = transformer.loss_fn(cfg, live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    *,
    grad_accum: int | None = None,
):
    """Returns train_step(params, opt_state, batch, step) -> (params, opt_state, metrics).

    grad_accum defaults to cfg.grad_accum.  Metrics are 0-d tensors on the
    params' device ("lr" on the host)."""
    accum = cfg.grad_accum if grad_accum is None else grad_accum

    def compute_grads(params, batch):
        if accum <= 1:
            return loss_and_grads(cfg, params, batch)
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=params["embed"].device)
        for i in range(accum):
            mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i] for k, v in batch.items()}
            loss, _, grads = loss_and_grads(cfg, params, mb)
            for a, g in zip(tree_leaves(gsum), tree_leaves(grads)):
                a.add_(g.float())
            loss_sum = loss_sum + loss
        for g in tree_leaves(gsum):
            g.div_(accum)
        return loss_sum / accum, {}, gsum

    def train_step(params, opt_state, batch, step):
        with mesh_ops(params):
            loss, metrics, grads = compute_grads(params, batch)
            grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
            params, opt_state, lr = adamw_step(opt_cfg, params, grads, opt_state, step)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update({k: v for k, v in metrics.items() if v.ndim == 0})
        return params, opt_state, {k: v.full_tensor() if is_dtensor(v) else v
                                   for k, v in out.items()}

    return train_step
