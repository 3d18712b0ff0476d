"""Abstract inputs of the dry-run: tensors on the ``meta`` device (shape
and dtype, no storage) with a ``NamedSharding`` beside each leaf as
``.sharding``, for every (architecture x shape) cell.

The torch counterpart of ``repro.launch.specs``, with its trees, dtypes
and specs.  The mesh is an abstract one that names the ``meta`` device
once a cell, e.g. ``make_production_mesh(devices=[torch.device("meta")]
* 256)``: ``NamedSharding`` accepts a mesh that names one device n
times, so the specs are JAX's for the same mesh shape, and no card is
needed.  :func:`per_device_bytes` sums each leaf's shard under its spec.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.roofline import shard_numel
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (
    Mesh,
    NamedSharding,
    PartitionSpec as P,
    ShardingRules,
    abstract_params,
    abstract_tensor,
)
from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

Tree = Any


def rules_for(cfg: ModelConfig) -> ShardingRules:
    return ShardingRules(fsdp=cfg.fsdp)


def _sds(shape, dtype, mesh: Mesh, spec: P) -> torch.Tensor:
    return abstract_tensor(shape, dtype, NamedSharding(mesh, spec))


def _batch_spec(mesh: Mesh, rules: ShardingRules, batch: int, extra_dims: int) -> P:
    b = rules.batch_axes(mesh)
    bsz = math.prod(mesh.shape[a] for a in b) if b else 1
    lead = (b if len(b) > 1 else b[0]) if (b and batch % bsz == 0) else None
    return P(lead, *([None] * extra_dims))


def batch_specs(
    cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, rules: ShardingRules
) -> Tree:
    """Token/embedding inputs for a train or prefill step."""
    b, s = shape.global_batch, shape.seq_len
    out: Tree = {
        "tokens": _sds((b, s), torch.int32, mesh, _batch_spec(mesh, rules, b, 1))
    }
    if cfg.input_mode == "embeddings":
        out["embeddings"] = _sds(
            (b, s, cfg.d_model), torch.bfloat16, mesh, _batch_spec(mesh, rules, b, 2)
        )
    if cfg.n_ctx_tokens:
        out["ctx"] = _sds(
            (b, cfg.n_ctx_tokens, cfg.d_model),
            torch.bfloat16,
            mesh,
            _batch_spec(mesh, rules, b, 2),
        )
    return out


def abstract_decode_state(
    cfg: ModelConfig, batch: int, s_max: int, mesh: Mesh, rules: ShardingRules
) -> Tree:
    """The decode state on ``meta``, each leaf sharded per the rules."""
    state = transformer.init_decode_state(cfg, batch, s_max, device="meta")
    axes = transformer.decode_state_axes(cfg)

    def attach(t, ax):
        if isinstance(t, dict):
            return {k: attach(t[k], ax[k]) for k in t}
        if isinstance(t, list):
            return [attach(a, b) for a, b in zip(t, ax)]
        spec = rules.param_spec(tuple(t.shape), tuple(ax), mesh)
        t.sharding = NamedSharding(mesh, spec)
        return t

    return attach(state, axes)


def abstract_opt_state(cfg: ModelConfig, mesh: Mesh, rules: ShardingRules) -> Tree:
    """fp32 AdamW moments: param shardings + ZeRO-1 (forced FSDP over data)."""
    zrules = dataclasses.replace(rules, fsdp=True, fsdp_min_bytes=1 << 20)
    return {"m": abstract_params(cfg, mesh, zrules, dtype=torch.float32),
            "v": abstract_params(cfg, mesh, zrules, dtype=torch.float32)}


def input_specs(
    arch: str, shape_name: str, mesh: Mesh
) -> tuple[ModelConfig, ShapeConfig, ShardingRules, Tree]:
    """All abstract inputs needed to run one (arch x shape) cell."""
    return input_specs_for(get_config(arch), shape_name, mesh)


def input_specs_for(
    cfg: ModelConfig, shape_name: str, mesh: Mesh
) -> tuple[ModelConfig, ShapeConfig, ShardingRules, Tree]:
    """Abstract inputs for an explicit config (perf-iteration variants).

    Returns (cfg, shape, rules, inputs) where inputs holds, per kind:
      train:   params (fp32), opt_state, batch, step
      prefill: params (bf16), batch
      decode:  params (bf16), state, tokens
    The train step's ``step`` is a replicated int32 scalar, as in JAX; the
    step function reads it on the host (the learning-rate schedule), so
    the dry-run hands it the integer 0 and counts these 4 bytes.
    """
    shape = SHAPES[shape_name]
    rules = rules_for(cfg)
    if shape.kind == "train":
        inputs = {
            "params": abstract_params(cfg, mesh, rules),
            "opt_state": abstract_opt_state(cfg, mesh, rules),
            "batch": batch_specs(cfg, shape, mesh, rules),
            "step": _sds((), torch.int32, mesh, P()),
        }
    elif shape.kind == "prefill":
        inputs = {
            "params": abstract_params(cfg, mesh, rules, dtype=torch.bfloat16),
            "batch": batch_specs(cfg, shape, mesh, rules),
        }
    else:  # decode
        b = shape.global_batch
        inputs = {
            "params": abstract_params(cfg, mesh, rules, dtype=torch.bfloat16),
            "state": abstract_decode_state(cfg, b, shape.seq_len, mesh, rules),
            "tokens": _sds((b, 1), torch.int32, mesh, _batch_spec(mesh, rules, b, 1)),
        }
        if cfg.input_mode == "embeddings":
            inputs["embeddings"] = _sds(
                (b, 1, cfg.d_model), torch.bfloat16, mesh, _batch_spec(mesh, rules, b, 2)
            )
    return cfg, shape, rules, inputs


def tensors(tree: Tree) -> list[torch.Tensor]:
    """The tensor leaves of a tree (dicts, lists, tuples; the decode
    state's ``tail`` is a list)."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def per_device_bytes(tree: Tree) -> int:
    """Bytes of one device's shards of every leaf of `tree`, each leaf's
    shard taken under its ``.sharding`` (a leaf without one is whole on
    every device)."""
    total = 0
    for t in tensors(tree):
        sh = getattr(t, "sharding", None)
        n = t.numel() if sh is None else shard_numel(t.shape, sh.spec, sh.mesh.shape)
        total += n * t.element_size()
    return total
