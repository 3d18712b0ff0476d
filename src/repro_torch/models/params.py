"""Parameter spec trees: shapes + dtypes + logical sharding axes + init.

The torch counterpart of ``repro.models.params``, with the same tree: a
config maps to a nested dict of ParamSpec, from which come materialized
parameters (`init_params`) and parameter counts.  Repeated layer groups
are stacked on a leading "layers" axis under ``blocks/sub{i}/...``; the
layers that do not fill a period sit under ``tail/layer{i}/...``.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any

import torch

from repro_torch.models.config import ModelConfig

Tree = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == ndim
    init: str = "normal"  # "normal" | "zeros" | "ones" | "embed"
    std: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _norm(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), "ones")


def _attn_specs(cfg: ModelConfig, cross: bool = False) -> Tree:
    d, nq, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(nq * hd)
    t: Tree = {
        "wq": ParamSpec((d, nq, hd), ("embed", "heads", "head_dim"), std=std_in),
        "wk": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim"), std=std_in),
        "wv": ParamSpec((d, nkv, hd), ("embed", "kv_heads", "head_dim"), std=std_in),
        "wo": ParamSpec((nq, hd, d), ("heads", "head_dim", "embed"), std=std_out),
    }
    if cfg.qk_norm:
        t["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        t["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    if cross:
        # tanh-gated residual injection (llama-3.2 vision style), opens at 0
        t["gate"] = ParamSpec((1,), (None,), "zeros")
    return t


def _ffn_specs(cfg: ModelConfig) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    t: Tree = {
        "w_up": ParamSpec((d, f), ("embed", "mlp"), std=std_in),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), std=std_out),
    }
    if cfg.act in ("swiglu", "geglu"):
        t["w_gate"] = ParamSpec((d, f), ("embed", "mlp"), std=std_in)
    return t


def _moe_specs(cfg: ModelConfig) -> Tree:
    d, e, fe = cfg.d_model, cfg.moe_experts, cfg.moe_dff
    std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(fe)
    return {
        "router": ParamSpec((d, e), ("embed", None), std=std_in),
        "w_gate": ParamSpec((e, d, fe), ("experts", "embed", "mlp"), std=std_in),
        "w_up": ParamSpec((e, d, fe), ("experts", "embed", "mlp"), std=std_in),
        "w_down": ParamSpec((e, fe, d), ("experts", "mlp", "embed"), std=std_out),
    }


def _rec_specs(cfg: ModelConfig) -> Tree:
    """RG-LRU mixer (Griffin recurrent block)."""
    d, w, cw = cfg.d_model, cfg.rec_dim, cfg.conv_width
    std_d, std_w = 1.0 / math.sqrt(d), 1.0 / math.sqrt(w)
    return {
        "w_in": ParamSpec((d, w), ("embed", "rec"), std=std_d),
        "w_gate_in": ParamSpec((d, w), ("embed", "rec"), std=std_d),
        "conv_w": ParamSpec((cw, w), (None, "rec"), std=0.1),
        "conv_b": ParamSpec((w,), ("rec",), "zeros"),
        "w_rx": ParamSpec((w, w), ("rec", "rec_in"), std=std_w),
        "b_rx": ParamSpec((w,), ("rec",), "zeros"),
        "w_ix": ParamSpec((w, w), ("rec", "rec_in"), std=std_w),
        "b_ix": ParamSpec((w,), ("rec",), "zeros"),
        # a = sigmoid(lambda); init so a^c is in a useful decay range
        "lam": ParamSpec((w,), ("rec",), "ones"),
        "w_out": ParamSpec((w, d), ("rec", "embed"), std=std_w),
    }


def _mlstm_specs(cfg: ModelConfig) -> Tree:
    d, inner, nh = cfg.d_model, cfg.xlstm_inner, cfg.n_heads
    hd = cfg.xlstm_head_dim
    std_d, std_i = 1.0 / math.sqrt(d), 1.0 / math.sqrt(inner)
    return {
        "w_in": ParamSpec((d, inner), ("embed", "inner"), std=std_d),
        "w_q": ParamSpec((inner, nh, hd), ("inner", "heads", "head_dim"), std=std_i),
        "w_k": ParamSpec((inner, nh, hd), ("inner", "heads", "head_dim"), std=std_i),
        "w_v": ParamSpec((inner, nh, hd), ("inner", "heads", "head_dim"), std=std_i),
        "w_i": ParamSpec((inner, nh), ("inner", "heads"), std=std_i),
        "b_i": ParamSpec((nh,), ("heads",), "zeros"),
        "w_f": ParamSpec((inner, nh), ("inner", "heads"), std=std_i),
        "b_f": ParamSpec((nh,), ("heads",), "ones"),  # forget bias > 0
        "w_o": ParamSpec((inner, inner), ("inner", "inner_in"), std=std_i),
        "h_norm": ParamSpec((hd,), ("head_dim",), "ones"),
        "w_down": ParamSpec((inner, d), ("inner", "embed"), std=std_i),
    }


def _slstm_specs(cfg: ModelConfig) -> Tree:
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    std_d, std_h = 1.0 / math.sqrt(d), 1.0 / math.sqrt(hd)
    return {
        # stacked (z, i, f, o) input projections and per-head recurrences
        "w_x": ParamSpec((d, 4, nh, hd), ("embed", None, "heads", "head_dim"), std=std_d),
        "r_h": ParamSpec((4, nh, hd, hd), (None, "heads", "head_dim", "head_dim_in"), std=std_h),
        "b": ParamSpec((4, nh, hd), (None, "heads", "head_dim"), "zeros"),
        "h_norm": ParamSpec((hd,), ("head_dim",), "ones"),
        "w_out": ParamSpec((d, d), ("embed", "embed_in"), std=std_d),
    }


_MIXERS = {
    "attn": lambda cfg: _attn_specs(cfg),
    "local": lambda cfg: _attn_specs(cfg),
    "cross": lambda cfg: _attn_specs(cfg, cross=True),
    "rec": _rec_specs,
    "mlstm": _mlstm_specs,
    "slstm": _slstm_specs,
}


def block_specs(cfg: ModelConfig, kind: str) -> Tree:
    t: Tree = {"pre_norm": _norm(cfg.d_model), "mixer": _MIXERS[kind](cfg)}
    if cfg.ffn_kind == "dense" and cfg.d_ff > 0:
        t["ffn_norm"] = _norm(cfg.d_model)
        t["ffn"] = _ffn_specs(cfg)
    elif cfg.ffn_kind == "moe":
        t["ffn_norm"] = _norm(cfg.d_model)
        t["moe"] = _moe_specs(cfg)
    return t


def _stack(tree: Tree, n: int) -> Tree:
    """Prefix every spec with a leading (n,) "layers" axis."""
    out: Tree = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _stack(v, n)
        else:
            out[k] = ParamSpec((n, *v.shape), ("layers", *v.axes), v.init, v.std)
    return out


def param_specs(cfg: ModelConfig) -> Tree:
    d, v = cfg.d_model, cfg.vocab_size
    t: Tree = {"final_norm": _norm(d)}
    # std 1/sqrt(d): with embed_scale (x*sqrt(d)) inputs are unit-variance,
    # and tied unembed logits stay O(1) at init either way.
    t["embed"] = ParamSpec((v, d), ("vocab", "embed"), "embed", std=1.0 / math.sqrt(d))
    if not cfg.tie_embeddings:
        t["unembed"] = ParamSpec((d, v), ("embed", "vocab"), std=1.0 / math.sqrt(d))
    if cfg.n_groups > 0:
        group: Tree = {
            f"sub{i}": block_specs(cfg, kind) for i, kind in enumerate(cfg.layer_pattern)
        }
        t["blocks"] = _stack(group, cfg.n_groups)
    else:
        t["blocks"] = {}
    t["tail"] = {
        f"layer{i}": block_specs(cfg, kind)
        for i, kind in enumerate(cfg.tail_pattern)
    }
    return t


def flatten_specs(tree: Tree, prefix: str = "") -> list[ParamSpec]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(flatten_specs(v, f"{prefix}{k}/"))
        elif isinstance(v, ParamSpec):
            out.append(v)
    return out


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype)
    return (torch.randn(spec.shape, generator=gen, dtype=torch.float32) * spec.std).to(dtype)


def leaf_seed(seed: int, path: str) -> int:
    """The generator seed of the leaf at `path` (``"blocks/sub0/mixer/wq"``):
    a crc32 of ``"<seed>/<path>"`` (the CPU generator keeps 32 bits of a seed)."""
    return zlib.crc32(f"{int(seed)}/{path}".encode())


def init_params(cfg: ModelConfig, seed: int = 0, device: torch.device | str | None = None,
                mesh=None, rules=None) -> Tree:
    """Materialize parameters on `device` (None: the card), or laid out
    on `mesh` by `rules` (default ``ShardingRules()``).

    Each "normal" or "embed" leaf is drawn whole on the CPU from its own
    ``torch.Generator``, seeded by :func:`leaf_seed` from `seed` and the
    leaf's path, so the same seed gives the same weights in
    every process and on every device.  On a mesh, each leaf is then
    placed by its sharding (``tree_param_shardings``): on a distributed
    mesh every rank draws the same whole leaf and keeps its shard, so the
    weights are the one-device weights.  JAX's ``init_params`` folds
    Python's ``hash()`` of the path into its key; ``hash()`` of a str is
    salted per process, so its weights differ from run to run and cannot
    be reproduced here: parity with the JAX package carries its
    parameters across (``repro_torch.convert.lm_params_from_jax``).
    """
    from repro_torch.core.hdc_model import resolve_device

    if mesh is not None:
        from repro_torch.distributed.sharding import ShardingRules, tree_param_shardings

        shardings = tree_param_shardings(mesh, param_specs(cfg), spec_tree_axes(cfg),
                                         rules or ShardingRules())
    else:
        dev = resolve_device(device)

    def walk(tree: Tree, path: tuple[str, ...], sh) -> Tree:
        out: Tree = {}
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,), None if sh is None else sh[k])
            else:
                gen = torch.Generator().manual_seed(leaf_seed(seed, "/".join(path + (k,))))
                leaf = _init_leaf(v, gen, cfg.pdtype())
                out[k] = leaf.to(dev) if sh is None else sh[k].place(leaf)
        return out

    return walk(param_specs(cfg), (), shardings if mesh is not None else None)


def spec_tree_axes(cfg: ModelConfig) -> Tree:
    """Tree of logical-axis tuples mirroring param_specs (for sharding)."""

    def walk(tree: Tree) -> Tree:
        return {
            k: walk(v) if isinstance(v, dict) else v.axes for k, v in tree.items()
        }

    return walk(param_specs(cfg))
