"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

The torch counterpart of ``repro.models.moe``: the GShard/Switch
capacity scheme expressed with a stable sort and scatter instead of the
(tokens, experts, capacity) one-hot einsum.

Semantics (tested against a dense per-token loop oracle):
  * router logits fp32, softmax over the top-k logits, renormalized;
  * capacity C = max(ceil(T * k / E * capacity_factor), min(T, 16));
    assignments beyond an expert's capacity, in the stable order of
    (expert, token, rank), are dropped (contribute 0 for that slot);
  * load-balancing aux loss: E * sum_e f_e * p_e (Switch).

Two dispatches, as in the JAX package: "gspmd" dispatches the whole
batch at once; "local" dispatches each batch shard of the current mesh
on its own, with a capacity from that shard's token count.  JAX's local
path sends each shard's dispatch buffer to the experts' owners along the
"model" axis and back (two all-to-alls); every owner computes its
experts on rows it received, so the exchange returns each shard the
outputs of every expert on its own rows.  One process drives every
cell of the port's meshes, so it computes those outputs in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import get_current_mesh
from repro_torch.models.config import ModelConfig


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (B, T, D), aux_loss scalar.  Dispatches to the
    configured implementation ("gspmd" global dispatch vs "local"
    per-shard dispatch under a current mesh with a "model" axis)."""
    mesh = get_current_mesh()
    if (
        cfg.moe_impl == "local"
        and mesh is not None
        and "model" in mesh.axis_names
        and cfg.moe_experts % mesh.shape["model"] == 0
    ):
        return _moe_ffn_local(cfg, p, x, mesh)
    return _moe_ffn_gspmd(cfg, p, x)


def _capacity(cfg: ModelConfig, n_tok: int) -> int:
    # the floor matters at decode (n_tok == batch): ceil(B*k/E*cf) rounds
    # to ~1 and hot experts would drop live traffic
    return max(int(math.ceil(n_tok * cfg.moe_topk / cfg.moe_experts * cfg.moe_capacity)),
               min(n_tok, 16))


def _route(cfg: ModelConfig, logits: torch.Tensor):
    """(probs, top_e, weights) of fp32 router logits (T, E)."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe_topk, dim=-1)
    weights = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_e, weights


def _dispatch_local(cfg: ModelConfig, tokens: torch.Tensor, logits: torch.Tensor,
                    capacity: int):
    """Capacity dispatch of tokens (T, D) -> ((E, C, D) buffer, combine info, aux)."""
    n_tok, d = tokens.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    probs, top_e, weights = _route(cfg, logits)

    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(e, dtype=flat_e.dtype, device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n_tok * k, device=tokens.device) - offsets[sorted_e]
    keep = rank < capacity
    dest = torch.where(keep, sorted_e * capacity + rank, e * capacity)  # drop slot
    buf = tokens.new_zeros((e * capacity + 1, d))
    buf[dest] = tokens[order // k]
    xs = buf[: e * capacity].reshape(e, capacity, d)
    aux_f = counts.float() / (n_tok * k)
    aux = e * torch.sum(aux_f * probs.mean(0)) * cfg.moe_aux_coef
    return xs, (order, dest, weights), aux


def _experts(p: dict, xs: torch.Tensor) -> torch.Tensor:
    """The grouped SwiGLU expert FFN: (E, C, D) -> (E, C, D)."""
    dt = xs.dtype
    gate = torch.bmm(xs, p["w_gate"].to(dt))
    up = torch.bmm(xs, p["w_up"].to(dt))
    return torch.bmm(F.silu(gate) * up, p["w_down"].to(dt))


def _combine_local(cfg: ModelConfig, out_ecd: torch.Tensor, info, n_tok: int) -> torch.Tensor:
    order, dest, weights = info
    e, c, d = out_ecd.shape
    k = cfg.moe_topk
    out_flat = torch.cat([out_ecd.reshape(e * c, d), out_ecd.new_zeros((1, d))], dim=0)
    unsorted = out_ecd.new_zeros((n_tok * k, d))
    unsorted[order] = out_flat[dest]  # dropped -> the 0 row
    return (unsorted.reshape(n_tok, k, d) * weights[..., None].to(out_ecd.dtype)).sum(1)


def _moe_ffn_gspmd(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (B, T, D), aux_loss scalar: one dispatch of all tokens."""
    b, t, d = x.shape
    tokens = x.reshape(b * t, d)
    logits = tokens.float() @ p["router"].float()
    xs, info, aux = _dispatch_local(cfg, tokens, logits, _capacity(cfg, b * t))
    y = _combine_local(cfg, _experts(p, xs), info, b * t)
    return y.reshape(b, t, d), aux


def _moe_ffn_local(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard dispatch: each batch shard of the mesh (its ``pod`` x
    ``data`` cells) routes its own tokens with its own capacity; the aux
    loss is the mean over shards (JAX's ``pmean``)."""
    b, t, d = x.shape
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n_shards = math.prod(mesh.shape[a] for a in batch_axes)
    if b % n_shards:
        return _moe_ffn_gspmd(cfg, p, x)  # non-divisible batch: fall back
    bl = b // n_shards
    cap = _capacity(cfg, bl * t)
    ys, auxes = [], []
    for xs in x.split(bl):
        tokens = xs.reshape(bl * t, d)
        logits = tokens.float() @ p["router"].float()
        buf, info, aux = _dispatch_local(cfg, tokens, logits, cap)
        ys.append(_combine_local(cfg, _experts(p, buf), info, bl * t).reshape(bl, t, d))
        auxes.append(aux)
    return torch.cat(ys), torch.stack(auxes).mean()


def moe_ffn_dense_oracle(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Reference: loop over experts densely, no capacity drops."""
    b, t, d = x.shape
    tokens = x.reshape(b * t, d).float()
    _, top_e, weights = _route(cfg, tokens @ p["router"].float())
    out = torch.zeros_like(tokens)
    for ei in range(cfg.moe_experts):
        gate = tokens @ p["w_gate"][ei].float()
        up = tokens @ p["w_up"][ei].float()
        y = (F.silu(gate) * up) @ p["w_down"][ei].float()
        w_e = torch.where(top_e == ei, weights, 0.0).sum(-1)  # (T,)
        out += y * w_e[:, None]
    return out.reshape(b, t, d).to(x.dtype)
