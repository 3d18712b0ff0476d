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
batch at once; "local" dispatches each batch shard of the mesh on its
own, with a capacity from that shard's token count, and averages the
shards' aux losses.

On a mesh of ranks (``x`` a ``DTensor``, one process a card) the experts
are laid out over the ``model`` axis, as JAX's ``shard_map`` and GSPMD
lay them out (:func:`_moe_ffn_exchange`, :func:`_moe_ffn_owners`): each
rank computes its E / M experts, their weights gathered whole (El, D, F)
from the rules' layout.  Without a group (a plain tensor under a
``Mesh`` of devices, such as the CPU tests' ``["cpu"] * 4``) one process
computes every expert of every batch shard itself
(:func:`_moe_ffn_local`): the outputs the two exchanges would return.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    PartitionSpec,
    constrain,
    get_current_mesh,
    is_dtensor,
    local_shard,
    model_group,
)
from repro_torch.models.config import ModelConfig


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (B, T, D), aux_loss scalar.  Dispatches to the
    configured implementation ("gspmd" global dispatch vs "local"
    per-shard dispatch under a mesh with a "model" axis): on a mesh of
    ranks the mesh is x's, else the current one."""
    if is_dtensor(x):
        return _moe_ffn_on_ranks(cfg, p, x)
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


# ---------------------------------------------------------------------------
# On a mesh of ranks (one process a card)
# ---------------------------------------------------------------------------


def _moe_ffn_on_ranks(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn` of a ``DTensor`` x: JAX's choice between its two
    dispatches, on x's mesh.  Experts that do not divide the ``model``
    axis take JAX's gspmd dispatch, whose ``P("model", …)`` constraint JAX
    then drops: every rank computes every expert."""
    dm = x.device_mesh
    shape = dict(zip(dm.mesh_dim_names, dm.shape))
    split = cfg.moe_experts % shape.get("model", 1) == 0
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    n_shards = math.prod(shape[a] for a in batch_axes)
    if split and cfg.moe_impl == "local" and "model" in shape and x.shape[0] % n_shards == 0:
        return _moe_ffn_exchange(cfg, p, x, batch_axes)
    # JAX's gspmd, and its fallback of a batch that does not divide
    return _moe_ffn_owners(cfg, p, x, split)


def _weights_local(p: dict, dm, split: bool = True) -> tuple[torch.Tensor, dict]:
    """The router whole and this rank's experts (El, D, F), each gathered
    from the rules' layout: the experts on ``model`` (dim 0), replicated
    elsewhere, as JAX's ``in_specs`` ``P("model", None, None)`` force, or
    all E of them where not `split`.  The local gradients are partial sums
    over the ranks that share the block (every rank for the router), as
    each rank weighs its own rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = dm.mesh_dim_names
    whole = [Replicate()] * dm.ndim
    router = local_shard(p["router"].redistribute(dm, whole), [Partial()] * dm.ndim)
    on = [Shard(0) if n == "model" and split else Replicate() for n in names]
    grad = [Shard(0) if n == "model" and split else Partial() for n in names]
    experts = {k: local_shard(p[k].redistribute(dm, on), grad) for k in ("w_gate", "w_up", "w_down")}
    return router, experts


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient by `s`."""

    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.s, None


def _wait(t: torch.Tensor) -> torch.Tensor:
    return torch.ops._c10d_functional.wait_tensor(t)


class _AllToAll(torch.autograd.Function):
    """All-to-all of the equal chunks of dim 0 over a group (chunk i goes
    to the group's rank i, and chunk i of the result came from it); the
    backward sends the gradient's chunks back the same way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _AllToAll.exchange(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.exchange(grad, ctx.group), None

    @staticmethod
    def exchange(t: torch.Tensor, group) -> torch.Tensor:
        splits = [t.shape[0] // group.size()] * group.size()
        return _wait(torch.ops._c10d_functional.all_to_all_single(
            t.contiguous(), splits, splits, group.group_name))


class _AllGather(torch.autograd.Function):
    """All-gather along dim 0 over a group; the backward sums the
    gradient over the group and hands each rank its chunk of it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _wait(torch.ops._c10d_functional.all_gather_into_tensor(
            t.contiguous(), group.size(), group.group_name))

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return _wait(torch.ops._c10d_functional.reduce_scatter_tensor(
            grad.contiguous(), "sum", g.size(), g.group_name)), None


class _MeanOverRanks(torch.autograd.Function):
    """JAX's ``pmean`` of each rank's value over every dim of a
    ``DeviceMesh``: an all-reduce a dim, over the rank count.  Every rank
    holds the mean's whole gradient, so each rank's term gets its share."""

    @staticmethod
    def forward(ctx, t, dm):
        ctx.n = dm.size()
        for i in range(dm.ndim):
            g = dm.get_group(i)
            t = _wait(torch.ops._c10d_functional.all_reduce(t, "sum", g.group_name))
        return t / ctx.n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def _replicated(t: torch.Tensor, dm):
    """A tensor every rank holds whole, as a replicated ``DTensor``."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, dm, [Replicate()] * dm.ndim, run_check=False)


def _moe_ffn_exchange(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      batch_axes: tuple[str, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``shard_map`` path (``repro/models/moe.py`` ``_moe_ffn_local``)
    on this rank's tokens: x's batch shards over `batch_axes`, the same
    on every ``model`` rank of a batch shard.  The rank dispatches its
    tokens into an (E, C, D) buffer with the capacity of its own token
    count, sends the (M, El, C, D) blocks to the experts' owners along
    ``model`` (an all-to-all), computes its El experts on the (El, M * C,
    D) rows it receives, and sends the results back (the second
    all-to-all) before the combine.  Within a batch shard every ``model``
    rank dispatches the same tokens, so an owner computes M copies of
    them, as JAX's does.  The aux loss is the mean over every rank.

    The gradients are JAX's transpose of that program: y, the same on
    the M ranks of a batch shard, passes each of them 1/M of its
    gradient, so that the local gradients of x and of the router are
    partial sums over ``model``, and an owner's expert gradient, summed
    over the M copies, is its batch shard's (partial over the batch
    axes)."""
    from torch.distributed.tensor import DTensor, Partial

    dm = x.device_mesh
    names = dm.mesh_dim_names
    b, t, d = x.shape
    e = cfg.moe_experts
    m_size = dm.size(names.index("model"))
    el = e // m_size
    x = constrain(x, PartitionSpec(batch_axes, None, None))
    router, w = _weights_local(p, dm)
    xl = local_shard(x, [Partial() if n == "model" else q for n, q in zip(names, x.placements)])
    bl = xl.shape[0]
    cap = _capacity(cfg, bl * t)
    tokens = xl.reshape(bl * t, d)
    buf, info, aux = _dispatch_local(cfg, tokens, tokens.float() @ router.float(), cap)
    group = model_group(dm)
    recv = _AllToAll.apply(buf.reshape(m_size, el, cap, d), group)  # from every peer, my experts
    out = _experts(w, recv.transpose(0, 1).reshape(el, m_size * cap, d))
    got = _AllToAll.apply(out.reshape(el, m_size, cap, d).transpose(0, 1), group)
    y = _combine_local(cfg, got.reshape(e, cap, d), info, bl * t).reshape(bl, t, d)
    y = DTensor.from_local(_ScaleGrad.apply(y, 1.0 / m_size), dm, x.placements, run_check=False,
                           shape=x.shape, stride=x.stride())
    return y, _replicated(_MeanOverRanks.apply(aux, dm), dm)


def _moe_ffn_owners(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    split: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's gspmd path on a mesh of ranks: the tokens gathered whole
    (over the batch axes), routed once on every rank, each rank computing
    its El experts of the (E, C, D) buffer (the buffer on ``model``, as
    JAX constrains it), and the experts' outputs all-gathered over
    ``model`` before the combine; where not `split` (the experts do not
    divide ``model``) every rank computes all E.  Every rank computes the same y, and
    passes 1/N of its gradient (N ranks), so that every local gradient
    is a partial sum over the mesh: the all-gather's backward sums the
    ``model`` ranks' shares, and the expert gradients are partial over
    the other axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    dm = x.device_mesh
    names = dm.mesh_dim_names
    b, t, d = x.shape
    n_all = dm.size()
    m_size = dm.size(names.index("model")) if "model" in names and split else 1
    el = cfg.moe_experts // m_size
    router, w = _weights_local(p, dm, split)
    xl = local_shard(x.redistribute(dm, [Replicate()] * dm.ndim), [Partial()] * dm.ndim)
    tokens = xl.reshape(b * t, d)
    buf, info, aux = _dispatch_local(cfg, tokens, tokens.float() @ router.float(),
                                     _capacity(cfg, b * t))
    if m_size > 1:
        lo = dm.get_local_rank("model") * el
        out = _AllGather.apply(_experts(w, buf[lo:lo + el]), model_group(dm))
    else:
        out = _experts(w, buf)
    y = _combine_local(cfg, out, info, b * t).reshape(b, t, d)
    y = DTensor.from_local(_ScaleGrad.apply(y, 1.0 / n_all), dm, [Replicate()] * dm.ndim,
                           run_check=False, shape=x.shape, stride=x.stride())
    return y, _replicated(_ScaleGrad.apply(aux, 1.0 / n_all), dm)


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
