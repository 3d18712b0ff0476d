"""Model assembly: block dispatch, the layer stack, loss, serving.

The torch counterpart of ``repro.models.transformer``.  Entry points,
all functions of (config, params, ...):

  * loss_fn(cfg, params, batch)          -> scalar loss, metrics
  * prefill(cfg, params, batch)          -> last-token logits, decode state
  * decode_step(cfg, params, state, tok) -> logits, new state

The layer groups' parameters are stacked on a leading axis, as in the
JAX package, and a Python loop takes them apart where JAX scans: one
``unbind`` of each stacked leaf per forward, so that a backward pass
stacks the layers' gradients once (an index per layer would give each
layer a zero gradient of the whole stack).  Under autograd with
``cfg.remat`` each block is rematerialized (``_block_fn``), as JAX's
``jax.checkpoint`` does per layer.  The non-dividing remainder of the
stack runs after the groups ("tail").

Decode state is {"pos": 0-d int32 tensor, "blocks": stacked per-group
caches, "tail": [...]} — attention KV caches (rolling for local layers),
RG-LRU/xLSTM recurrent states, cross-attention context KV.  A decode
step updates the state in place: the KV caches take the new row where
they lie, and the recurrent states are copied into their stacked slots.

On a mesh (one process a card; ``distributed.sharding``) the params are
``DTensor``s and every entry point runs on them under
``sharding.mesh_ops``: ``constrain`` lays the activations out at JAX's
four places (the residual after each mixer and each FFN and the embedded
input over the batch axes, the logits over the batch axes and ``model``
on the vocab), and DTensor's sharding propagation does the rest, as GSPMD
does for JAX.  The stacked ``layers`` axis is never sharded (JAX's
rule), so unbinding it needs no collective.  The loss over vocab-sharded
logits takes JAX's form there (``_ce_chunk``).  A prefill lays its
caches out by ``decode_state_axes`` through ``param_spec``'s ``batch``
rule.  Every arch is laid out: attention (self and cross) computes per
shard (``attention._per_shard``), the experts lie over ``model`` and are
exchanged by all-to-all (``moe``), the RG-LRU and xLSTM mixers run on each
rank's batch shard and its channels or heads (``per_shard``), and an
embedding input arrives laid out over the batch axes as tokens do.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.distributed.sharding import (
    PartitionSpec as P,
    constrain,
    constrain_logical,
    contiguous_stride,
    is_dtensor,
    mesh_ops,
)
from repro_torch.models import attention, layers, moe, recurrent, xlstm
from repro_torch.models.config import ModelConfig

Tree = dict[str, Any]

# The leaves the JAX package casts to the compute dtype at every use
# (``p[...].astype(dt)``), by leaf name; every other leaf (norm scales,
# the MoE router, the RG-LRU gates, the mLSTM q/k/v/i/f and the sLSTM
# projections, the cross-attention gate) is used in float32.
COMPUTE_CAST = frozenset({
    "embed", "unembed",  # embedding lookup, unembedding
    "wq", "wk", "wv", "wo",  # attention
    "w_up", "w_gate", "w_down",  # dense FFN and MoE experts (w_down: also mLSTM)
    "w_in", "w_gate_in", "conv_w", "conv_b", "w_out",  # RG-LRU (w_in, w_out: also xLSTM)
    "w_o",  # mLSTM output gate
})


def cast_for_compute(cfg: ModelConfig, params: Tree) -> Tree:
    """`params` with the COMPUTE_CAST leaves in the compute dtype.  A cast
    is deterministic, so a model run on the result computes what it
    computes on the float32 masters, without casting on every step."""
    dt = cfg.cdtype()

    def walk(tree: Tree) -> Tree:
        return {k: walk(v) if isinstance(v, dict) else (v.to(dt) if k in COMPUTE_CAST else v)
                for k, v in tree.items()}

    return walk(params)


# ---------------------------------------------------------------------------
# Single block
# ---------------------------------------------------------------------------


def apply_block(
    cfg: ModelConfig,
    kind: str,
    p: Tree,
    x: torch.Tensor,
    *,
    mode: str,
    positions: torch.Tensor | None = None,
    ctx: torch.Tensor | None = None,
    cache: Tree | None = None,
    pos: torch.Tensor | None = None,
    max_len: int = 0,
) -> tuple[torch.Tensor, Tree | None, torch.Tensor]:
    """One residual block: mixer (+ cache) then FFN.  Returns (x, new_cache, aux)."""
    h = layers.rms_norm(x, p["pre_norm"])
    mixer_cache = cache.get("mixer") if cache else None

    if kind in ("attn", "local"):
        y, new_mc = attention.self_attention(
            cfg, p["mixer"], h, positions, local=(kind == "local"), mode=mode,
            cache=mixer_cache, pos=pos, max_len=max_len,
        )
    elif kind == "cross":
        y, new_mc = attention.cross_attention(
            cfg, p["mixer"], h, mode=mode, ctx=ctx, cache=mixer_cache
        )
    elif kind == "rec":
        y, new_mc = recurrent.recurrent_block(cfg, p["mixer"], h, mode=mode, state=mixer_cache)
    elif kind == "mlstm":
        y, new_mc = xlstm.mlstm_block(cfg, p["mixer"], h, mixer_cache, mode=mode)
    elif kind == "slstm":
        y, new_mc = xlstm.slstm_block(cfg, p["mixer"], h, mixer_cache, mode=mode)
    else:
        raise ValueError(f"unknown mixer kind {kind!r}")

    x = constrain(x + y, P(("pod", "data"), None, None))

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.ffn_kind == "dense" and cfg.d_ff > 0:
        h2 = layers.rms_norm(x, p["ffn_norm"])
        x = x + layers.ffn(p["ffn"], h2, cfg.act, x.dtype)
    elif cfg.ffn_kind == "moe":
        h2 = layers.rms_norm(x, p["ffn_norm"])
        y2, aux = moe.moe_ffn(cfg, p["moe"], h2)
        x = x + y2
    x = constrain(x, P(("pod", "data"), None, None))
    new_cache = None if new_mc is None and mode == "train" else {"mixer": new_mc}
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# The stack (groups + tail)
# ---------------------------------------------------------------------------


# JAX's "dots" remat policy (dots_with_no_batch_dims_saveable): the
# products without batch dimensions are saved, everything else is
# recomputed.  ``x @ w`` of activations and a weight is an mm (or addmm)
# here; the attention scores and the MoE experts are bmm (a batch dim)
# and are recomputed, as under JAX's policy.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _block_fn(cfg: ModelConfig, kind: str, kw: dict):
    """One block as f(bparams, x, cache) -> (x, new_cache, aux).

    Under autograd in train mode with ``cfg.remat``, the block is
    rematerialized PER LAYER (``torch.utils.checkpoint``, non-reentrant):
    the backward recomputes one layer at a time and holds only that
    layer's residuals.  Policy "nothing" saves nothing inside the block;
    "dots" saves its weight products (``_save_dots``)."""

    def f(bparams, x, cache):
        return apply_block(cfg, kind, bparams, x, cache=cache, **kw)

    if not (cfg.remat and kw["mode"] == "train" and torch.is_grad_enabled()):
        return f
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                  if cfg.remat_policy == "dots" else noop_context_fn)

    def remat(bparams, x, cache):
        return checkpoint(f, bparams, x, cache, use_reentrant=False, preserve_rng_state=False,
                          context_fn=context_fn)

    return remat


def _tree_index(tree: Tree, i: int) -> Tree:
    """Layer group i of a stacked tree (views)."""
    return {k: _tree_index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _tree_unbind(tree: Tree, n: int) -> list[Tree]:
    """The n layer groups of a stacked tree: one ``unbind`` per leaf."""
    parts = {k: _tree_unbind(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _tree_stack(trees: list[Tree]) -> Tree:
    return {k: _tree_stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def _tree_write(dst: Tree, i: int, src: Tree) -> None:
    """Copy src into layer group i of the stacked dst, leaf by leaf, except
    the leaves that already are that group's storage (the KV caches a
    decode step wrote in place)."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _tree_write(v, i, src[k])
        elif _ptr(src[k]) != _ptr(v[i]):
            _copy_into(v[i], src[k])


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src); on a mesh each rank copies its shard of src, laid
    out as dst, into dst's local storage."""
    if is_dtensor(dst):
        dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())
    else:
        dst.copy_(src)


def _ptr(t: torch.Tensor) -> int:
    """The address of `t`'s data (of this rank's shard for a DTensor)."""
    return (t.to_local() if is_dtensor(t) else t).data_ptr()


def run_stack(
    cfg: ModelConfig,
    params: Tree,
    x: torch.Tensor,
    *,
    mode: str,
    positions: torch.Tensor | None,
    ctx: torch.Tensor | None,
    caches: Tree | None = None,
    pos: torch.Tensor | None = None,
    max_len: int = 0,
) -> tuple[torch.Tensor, Tree | None, torch.Tensor]:
    """Apply all layers.  Returns (x, new_caches, aux_loss).  In decode
    mode the group caches of `caches` are updated in place and returned."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with_cache = mode != "train"
    kw = dict(mode=mode, positions=positions, ctx=ctx, pos=pos, max_len=max_len)

    new_caches: Tree = {}
    if cfg.n_groups > 0 and cfg.scan_layers:
        stacked = caches["blocks"] if caches else None
        fns = [_block_fn(cfg, kind, kw) for kind in cfg.layer_pattern]
        per_group = []
        for gi, gparams in enumerate(_tree_unbind(params["blocks"], cfg.n_groups)):
            gcache = _tree_index(stacked, gi) if stacked else {}
            group_caches = {}
            for i, fn in enumerate(fns):
                sub = f"sub{i}"
                x, nc, a = fn(gparams[sub], x, gcache.get(sub))
                group_caches[sub] = nc
                aux = aux + a
            if mode == "decode":
                _tree_write(stacked, gi, group_caches)
            per_group.append(group_caches)
        if mode == "decode":
            new_caches["blocks"] = stacked
        elif with_cache:
            new_caches["blocks"] = _tree_stack(per_group)
    tail_caches = []
    for i, kind in enumerate(cfg.tail_pattern):
        tc = caches["tail"][i] if caches else None
        x, nc, a = _block_fn(cfg, kind, kw)(params["tail"][f"layer{i}"], x, tc)
        aux = aux + a
        tail_caches.append(nc)
    if with_cache:
        new_caches["tail"] = tail_caches
    return x, (new_caches if with_cache else None), aux


# ---------------------------------------------------------------------------
# Embedding in / logits out
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params: Tree, batch: Tree, positions) -> torch.Tensor:
    dt = cfg.cdtype()
    if cfg.input_mode == "embeddings":
        x = batch["embeddings"].to(dt)
        # stub modality frontend supplies frame/patch embeddings; add
        # sinusoidal positions (musicgen backbone convention)
        x = x + layers.sinusoidal_positions(positions, cfg.d_model).to(dt)
    else:
        x = _lookup(params["embed"], batch["tokens"]).to(dt)
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(dt)
    return constrain(x, P(("pod", "data"), None, None))


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `embed` at `tokens`; on a mesh, :func:`_lookup_per_shard`."""
    if is_dtensor(embed):
        return _lookup_per_shard(embed, tokens)
    return embed[tokens]


def _lookup_per_shard(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """A vocab-parallel lookup: each rank keeps its vocab rows of the table
    (gathered over the embed dim where FSDP splits it), looks up the tokens
    of its batch rows that fall in them, zeros elsewhere, and the partial
    rows are summed over the vocab shards (an all-reduce of (B, S, D), as
    XLA partitions JAX's gather).  DTensor's own rules for a gather from a
    vocab-sharded table fail in torch 2.11 (``index_put`` in the backward)
    and in 2.13 (the embedding's masked partial over a 2-d mesh)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = embed.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, dm, [Replicate()] * dm.ndim, run_check=False)
    e_pl = [Shard(0) if p.is_shard(0) else Replicate() for p in embed.placements]
    t_pl = [p if p.is_shard(0) and not q.is_shard() else Replicate()
            for p, q in zip(tokens.placements, e_pl)]
    e, tokens = embed.redistribute(dm, e_pl), tokens.redistribute(dm, t_pl)
    el = e.to_local(grad_placements=[Partial() if t.is_shard() else q for t, q in zip(t_pl, e_pl)])
    tl = tokens.to_local().long()
    n, shard = el.shape[0], 0
    for i, q in enumerate(e_pl):  # this rank's vocab block, the first mesh dim the major one
        if q.is_shard():
            shard = shard * dm.size(i) + dm.get_local_rank(i)
    rel = tl - shard * n
    inside = (rel >= 0) & (rel < n)
    rows = el[torch.where(inside, rel, 0)] * inside[..., None].to(el.dtype)
    out = [Shard(0) if t.is_shard() else Partial() if q.is_shard() else Replicate()
           for t, q in zip(t_pl, e_pl)]
    shape = torch.Size((*tokens.shape, embed.shape[1]))
    y = DTensor.from_local(rows, dm, out, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    return y.redistribute(dm, [Replicate() if p.is_partial() else p for p in out])


def _unembed_weight(cfg: ModelConfig, params: Tree) -> torch.Tensor:
    """The (D, V) unembedding: the tied embedding's transpose, or its own leaf."""
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def _logits(cfg: ModelConfig, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 (softcapped) logits of x against a (D, V) weight in x's dtype."""
    return constrain(layers.softcap((x @ w).float(), cfg.logit_softcap),
                     P(("pod", "data"), None, "model"))


def unembed(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    return _logits(cfg, _unembed_weight(cfg, params).to(x.dtype), x)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


class _Cast(torch.autograd.Function):
    """``w_cast``, a compute-dtype copy of the master `w` made once per
    forward, standing in for ``w.to(w_cast.dtype)`` at one use: the
    backward hands this use's gradient to `w` in w's dtype.  Applied once
    a use, so autograd sums the uses' gradients in float32 at `w`, as JAX
    sums the cotangents of its per-use casts."""

    @staticmethod
    def forward(ctx, w, w_cast):
        ctx.dtype = w.dtype
        return w_cast.view_as(w_cast)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def _ce_chunk(cfg: ModelConfig, w: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor):
    """CE over one sequence chunk, run under ``checkpoint``: the (B, L, V)
    float32 logits are recomputed in the backward instead of being saved
    once per chunk."""
    logits = _logits(cfg, w, h)
    if is_dtensor(logits):
        from torch.distributed.tensor import Replicate

        # On a mesh the logits' vocab is sharded over ``model`` (JAX
        # transformer.py:220), and the loss takes JAX's form so that no
        # rank gathers them: the max and the sum of the logsumexp and the
        # gold logit's one-hot sum are reductions over the vocab shards
        # (all-reduces of (B, L)), as XLA partitions JAX's loss.
        # ``loss_parallel`` is not used: it takes logits sharded on the
        # class dim of a 1-d mesh, and these are sharded over the batch
        # axes as well.
        # The sum of the exponentials is made whole on every rank before the
        # log: where the log's input is left ``Partial`` on a mesh with
        # data > 1, torch 2.11's DTensor divides its gradient by each
        # rank's partial sum.
        m = logits.detach().amax(-1, keepdim=True)
        z = torch.exp(logits - m).sum(-1)
        z = z.redistribute(z.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in z.placements])
        logz = torch.log(z) + m[..., 0]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = (logits * (labels[..., None].long() == vocab)).sum(-1)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        # The gold logit by a gather.  JAX takes an einsum with a one-hot,
        # so that logits sharded over the vocab need no all-gather; on one
        # card the two are equal (the einsum's terms are x*0 = 0 and x*1 =
        # x, so it sums exactly the gold logit), and the gather builds no
        # (B, L, V) one-hot.
        gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    ce = (logz - gold) * mask
    return ce.sum(), mask.sum()


def on_mesh(fn):
    """Run an entry point f(cfg, params, ...) under ``mesh_ops(params)``."""

    @functools.wraps(fn)
    def wrapped(cfg, params, *args, **kwargs):
        with mesh_ops(params):
            return fn(cfg, params, *args, **kwargs)

    return wrapped


@on_mesh
def loss_fn(cfg: ModelConfig, params: Tree, batch: Tree) -> tuple[torch.Tensor, Tree]:
    """Causal LM loss.  batch: {"tokens": (B, S)} (+"embeddings"/"ctx")."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    x = embed_inputs(cfg, params, batch, positions)
    ctx = batch.get("ctx")
    if ctx is not None:
        ctx = ctx.to(cfg.cdtype())
    x, _, aux = run_stack(cfg, params, x, mode="train", positions=positions, ctx=ctx)
    x = layers.rms_norm(x, params["final_norm"])

    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.cat([torch.ones((b, s - 1), dtype=torch.float32, device=dev),
                      torch.zeros((b, 1), dtype=torch.float32, device=dev)], dim=1)
    w = _unembed_weight(cfg, params)
    w_cast = w.detach().to(x.dtype) if w.dtype != x.dtype else None  # once a step

    def chunk(lo: int, hi: int):
        wc = w if w_cast is None else _Cast.apply(w, w_cast)
        return checkpoint(_ce_chunk, cfg, wc, x[:, lo:hi], labels[:, lo:hi], mask[:, lo:hi],
                          use_reentrant=False, preserve_rng_state=False)

    n_chunks = max(1, cfg.loss_seq_chunks)
    if n_chunks > 1 and s % n_chunks == 0:
        # peak logits memory is (B, S/n, V) float32
        l = s // n_chunks
        tot = cnt = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_chunks):
            t, c = chunk(i * l, (i + 1) * l)
            tot, cnt = tot + t, cnt + c
    else:
        tot, cnt = chunk(0, s)
    ce = tot / torch.clamp(cnt, min=1.0)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_decode_state(
    cfg: ModelConfig, batch: int, s_max: int, dtype=None, device=None
) -> Tree:
    """Allocate the full decode state for a batch and max context length."""
    dt = dtype or cfg.cdtype()

    def one(kind: str) -> Tree:
        if kind in ("attn", "local"):
            return {"mixer": attention.init_self_cache(
                cfg, batch, s_max, local=(kind == "local"), dtype=dt, device=device)}
        if kind == "cross":
            return {"mixer": attention.init_cross_cache(cfg, batch, dt, device)}
        if kind == "rec":
            return {"mixer": recurrent.init_rec_state(cfg, batch, dt, device)}
        if kind == "mlstm":
            return {"mixer": xlstm.init_mlstm_state(cfg, batch, device)}
        if kind == "slstm":
            return {"mixer": xlstm.init_slstm_state(cfg, batch, device)}
        raise ValueError(kind)

    group = {f"sub{i}": one(k) for i, k in enumerate(cfg.layer_pattern)}
    stacked = _tree_stack([group] * cfg.n_groups) if cfg.n_groups else {}
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "blocks": stacked,
        "tail": [one(k) for k in cfg.tail_pattern],
    }


def decode_state_axes(cfg: ModelConfig) -> Tree:
    """Logical sharding axes mirroring init_decode_state's tree structure."""

    def one(kind: str) -> Tree:
        if kind in ("attn", "local", "cross"):
            kv = ("batch", None, "kv_heads", "head_dim")
            return {"mixer": {"k": kv, "v": kv}}
        if kind == "rec":
            return {"mixer": {"h": ("batch", "rec"), "conv": ("batch", None, "rec")}}
        if kind == "mlstm":
            return {"mixer": {
                "c": ("batch", "heads", "head_dim", "head_dim2"),
                "n": ("batch", "heads", "head_dim"),
                "m": ("batch", "heads"),
            }}
        if kind == "slstm":
            s = ("batch", "heads", "head_dim")
            return {"mixer": {"c": s, "n": s, "m": s, "h": s}}
        raise ValueError(kind)

    def stack(tree: Tree) -> Tree:
        return {k: stack(v) if isinstance(v, dict) else ("layers", *v) for k, v in tree.items()}

    group = {f"sub{i}": one(k) for i, k in enumerate(cfg.layer_pattern)}
    return {
        "pos": (),
        "blocks": stack(group) if cfg.n_groups else {},
        "tail": [one(k) for k in cfg.tail_pattern],
    }


def _device_of(batch: Tree) -> torch.device:
    return (batch["embeddings"] if "embeddings" in batch else batch["tokens"]).device


def _lay_out_state(cfg: ModelConfig, state: Tree) -> Tree:
    """The decode caches of a prefill on a mesh, each laid out by its
    ``decode_state_axes`` (the ``batch`` rule of ``param_spec``)."""

    def walk(t, ax):
        if isinstance(t, dict):
            return {k: walk(t[k], ax[k]) for k in t}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, ax)]
        return constrain_logical(t, ax)

    axes = decode_state_axes(cfg)
    return {k: walk(v, axes[k]) for k, v in state.items()}


@on_mesh
def prefill(
    cfg: ModelConfig, params: Tree, batch: Tree, max_len: int | None = None
) -> tuple[torch.Tensor, Tree]:
    """Process the prompt; returns (last-token logits (B, V), decode state).

    `max_len` is the decode budget: global-attention KV caches are
    padded to it (default prompt + 128)."""
    b, s = batch["tokens"].shape
    if max_len is None:
        max_len = s + 128
    dev = _device_of(batch)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    x = embed_inputs(cfg, params, batch, positions)
    ctx = batch.get("ctx")
    if ctx is not None:
        ctx = ctx.to(cfg.cdtype())
    x, caches, _ = run_stack(
        cfg, params, x, mode="prefill", positions=positions, ctx=ctx, max_len=max_len,
    )
    x = layers.rms_norm(x, params["final_norm"])
    logits = unembed(cfg, params, x[:, -1:])[:, 0]
    if is_dtensor(x):
        caches = _lay_out_state(cfg, caches)
    caches["pos"] = torch.full((), s, dtype=torch.int32, device=dev)
    return logits, caches


@on_mesh
def decode_step(
    cfg: ModelConfig, params: Tree, state: Tree, tokens: torch.Tensor, **extra
) -> tuple[torch.Tensor, Tree]:
    """One serving step: tokens (B, 1) -> logits (B, V), updated state
    (the same caches, updated in place, with the position advanced)."""
    pos = state["pos"]
    if is_dtensor(pos):  # a replicated scalar: every rank holds it whole
        pos = pos.to_local()
    positions = pos.reshape(1, 1)
    batch = {"tokens": tokens, **extra}
    x = embed_inputs(cfg, params, batch, positions)
    x, caches, _ = run_stack(
        cfg, params, x, mode="decode", positions=positions, ctx=None, caches=state, pos=pos,
    )
    x = layers.rms_norm(x, params["final_norm"])
    logits = unembed(cfg, params, x)[:, 0]
    caches["pos"] = pos + 1
    return logits, caches


@on_mesh
def forward_logits(cfg: ModelConfig, params: Tree, batch: Tree) -> torch.Tensor:
    """Logits (B, S, V) at every position of a full forward pass (train
    mode): the teacher-forcing reference for prefill and decode."""
    s = batch["tokens"].shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=_device_of(batch))[None, :]
    x = embed_inputs(cfg, params, batch, positions)
    ctx = batch.get("ctx")
    if ctx is not None:
        ctx = ctx.to(cfg.cdtype())
    x, _, _ = run_stack(cfg, params, x, mode="train", positions=positions, ctx=ctx)
    return unembed(cfg, params, layers.rms_norm(x, params["final_norm"]))
