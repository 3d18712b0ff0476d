"""Model assembly: block dispatch, the layer stack, serving.

The torch counterpart of ``repro.models.transformer``'s forward and
serving half (``loss_fn`` waits for the training slice).  Entry points,
all functions of (config, params, ...):

  * run_stack(cfg, params, x, mode="train", ...) -> hidden states (a
    forward pass; the teacher-forcing reference)
  * prefill(cfg, params, batch)          -> last-token logits, decode state
  * decode_step(cfg, params, state, tok) -> logits, new state

The layer groups' parameters are stacked on a leading axis, as in the
JAX package, and a Python loop indexes them where JAX scans.  JAX's
rematerialization only shapes a backward pass, so this forward has
none.  The non-dividing remainder of the stack runs after the groups
("tail").

Decode state is {"pos": 0-d int32 tensor, "blocks": stacked per-group
caches, "tail": [...]} — attention KV caches (rolling for local layers),
RG-LRU/xLSTM recurrent states, cross-attention context KV.  A decode
step updates the state in place: the KV caches take the new row where
they lie, and the recurrent states are copied into their stacked slots.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed.sharding import constrain
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
        if mode == "decode":
            y, new_mc = xlstm.mlstm_step(cfg, p["mixer"], h, mixer_cache)
        else:
            y, new_mc = xlstm.mlstm_chunkwise(
                cfg, p["mixer"], h, None, return_state=(mode == "prefill")
            )
    elif kind == "slstm":
        y, new_mc = xlstm.slstm_block(cfg, p["mixer"], h, mixer_cache, mode=mode)
    else:
        raise ValueError(f"unknown mixer kind {kind!r}")

    x = constrain(x + y)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.ffn_kind == "dense" and cfg.d_ff > 0:
        h2 = layers.rms_norm(x, p["ffn_norm"])
        x = x + layers.ffn(p["ffn"], h2, cfg.act, x.dtype)
    elif cfg.ffn_kind == "moe":
        h2 = layers.rms_norm(x, p["ffn_norm"])
        y2, aux = moe.moe_ffn(cfg, p["moe"], h2)
        x = x + y2
    x = constrain(x)
    new_cache = None if new_mc is None and mode == "train" else {"mixer": new_mc}
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# The stack (groups + tail)
# ---------------------------------------------------------------------------


def _tree_index(tree: Tree, i: int) -> Tree:
    """Layer group i of a stacked tree (views)."""
    return {k: _tree_index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


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
        elif src[k].data_ptr() != v[i].data_ptr():
            v[i].copy_(src[k])


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
        per_group = []
        for gi in range(cfg.n_groups):
            gparams = _tree_index(params["blocks"], gi)
            gcache = _tree_index(stacked, gi) if stacked else {}
            group_caches = {}
            for i, kind in enumerate(cfg.layer_pattern):
                sub = f"sub{i}"
                x, nc, a = apply_block(cfg, kind, gparams[sub], x, cache=gcache.get(sub), **kw)
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
        x, nc, a = apply_block(cfg, kind, params["tail"][f"layer{i}"], x, cache=tc, **kw)
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
        x = params["embed"][batch["tokens"]].to(dt)
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(dt)
    return constrain(x)


def unembed(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].to(x.dtype).T if cfg.tie_embeddings else params["unembed"].to(x.dtype)
    logits = x @ w
    return constrain(layers.softcap(logits.float(), cfg.logit_softcap))


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
    caches["pos"] = torch.full((), s, dtype=torch.int32, device=dev)
    return logits, caches


def decode_step(
    cfg: ModelConfig, params: Tree, state: Tree, tokens: torch.Tensor, **extra
) -> tuple[torch.Tensor, Tree]:
    """One serving step: tokens (B, 1) -> logits (B, V), updated state
    (the same caches, updated in place, with the position advanced)."""
    pos = state["pos"]
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
