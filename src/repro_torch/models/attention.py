"""GQA attention: global / sliding-window / cross, train + prefill + decode.

The torch counterpart of ``repro.models.attention``.  Decode uses a KV
cache; "local" mixers use a *rolling* cache of window_size slots (slot =
pos % window), which bounds long-context KV memory.  RoPE is applied
before caching, so rolled slots keep absolute phases.  A decode step
writes its new K/V into the cache tensors in place (the JAX server
donates the cache to the same effect).

Scores are float32 products of the compute-dtype operands, softcapped,
masked with NEG_INF and softmaxed in float32 before the cast to v's
dtype, as in the JAX package.  ``scaled_dot_product_attention`` is not
used: its bf16 path neither scores in float32 nor softcaps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed.sharding import (
    PartitionSpec as P, constrain, contiguous_stride, is_dtensor, local_shard)
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG_INF = -2.0**30


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dnh->btnh"): x (B, T, D) @ w (D, n, h)."""
    if is_dtensor(w) and any(p.is_shard(2) for p in w.placements):
        return _proj_per_shard(x, w)
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _proj_per_shard(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`_proj` of a weight sharded on its head_dim (the heads do not
    divide the ``model`` axis), on each rank's shards: such a layout has
    no flattened form for DTensor's view ops (torch 2.11 refuses the
    view, and its einsum takes the same view).  The weight is gathered
    over its embed dim (FSDP), x keeps its batch shards where the weight
    is whole, and each rank multiplies its local blocks; the output is
    sharded on the batch and on the weight's n / h dims, and the local
    gradients are partial sums over the dims the product contracted
    across ranks (x's over the weight's shards, the weight's over x's)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = w.device_mesh
    w_pl = [Replicate() if p.is_shard(0) else p for p in w.placements]
    x_pl = [p if p.is_shard(0) and not q.is_shard() else Replicate()
            for p, q in zip(x.placements, w_pl)]
    x, w = x.redistribute(dm, x_pl), w.redistribute(dm, w_pl)
    xl = x.to_local(grad_placements=[Partial() if q.is_shard() else p for p, q in zip(x_pl, w_pl)])
    wl = w.to_local(grad_placements=[Partial() if p.is_shard() else q for p, q in zip(x_pl, w_pl)])
    yl = (xl @ wl.reshape(wl.shape[0], -1)).unflatten(-1, wl.shape[1:])
    out = [Shard(0) if p.is_shard() else Shard(q.dim + 1) if q.is_shard() else Replicate()
           for p, q in zip(x_pl, w_pl)]
    shape = torch.Size((*x.shape[:-1], *w.shape[1:]))
    return DTensor.from_local(yl, dm, out, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_src: torch.Tensor):
    dt = x.dtype
    q = _proj(x, p["wq"].to(dt))
    k = _proj(kv_src, p["wk"].to(dt))
    v = _proj(kv_src, p["wv"].to(dt))
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"])
        k = layers.rms_norm(k, p["k_norm"])
    return q, k, v


def _per_shard(cfg: ModelConfig, fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """fn(cfg, q, k, v, psum) -> (B, T, nq, hd), run on each rank's shards
    where q, k, v are ``DTensor``s: the batch over the batch axes, and on
    the ``model`` axis (m ranks) one of four layouts, the first three of
    which compute no head twice:

    * heads: the query and the kv heads both divide m.  Each rank's query
      heads meet exactly their kv heads; no collective runs inside.
    * kv heads gathered: the query heads divide m and the kv heads do not,
      and there is more than one query row (train, prefill) or head_dim
      does not divide m.  q keeps its heads on ``model``, k and v are
      gathered whole over it, and each rank attends with the kv heads its
      query heads read (GQA's kv replication); their gradients go back as
      partial sums.
    * head_dim: one query row (decode, whose cache ``decode_state_axes``
      shards on head_dim when the kv heads do not divide m), or query heads
      that do not divide m.  q, k and v are sharded on head_dim; each
      rank's scores are partial sums over its slice of it, all-reduced over
      ``model`` (``psum``) before the scale, the softcap and the softmax,
      and the output keeps head_dim on ``model``.  At decode this sends a
      row of scores a head where gathering would send the whole cache.
    * whole: head counts and a head_dim that do not divide m.  JAX's
      ``constrain`` drops ``model`` there and GSPMD keeps the heads whole
      on it, so every rank of a batch shard attends with all of them.

    The masks and the online-softmax loop are plain tensors, which spares
    DTensor's sharding propagation of every op of the loop."""
    if not is_dtensor(q):
        return fn(cfg, q, k, v, None)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    dm = q.device_mesh
    names = tuple(dm.mesh_dim_names)
    m = dict(zip(names, dm.shape)).get("model", 1)
    nq, nkv, g = cfg.n_heads, cfg.n_kv_heads, cfg.q_per_kv
    nq_l = nq // m
    if nq % m == 0 and nkv % m == 0:
        layout = "heads"
    elif (nq % m == 0 and (nq_l % g == 0 or g % nq_l == 0)
          and (q.shape[1] > 1 or cfg.head_dim % m)):
        layout = "kv_gathered"
    elif cfg.head_dim % m == 0:
        layout = "head_dim"
    else:
        layout = "whole"
    batch = ("pod", "data")
    whole = P(batch, None, None, None)
    by_heads, by_hd = P(batch, None, "model", None), P(batch, None, None, "model")
    q = constrain(q, {"head_dim": by_hd, "whole": whole}.get(layout, by_heads))
    kv_spec = {"heads": by_heads, "kv_gathered": whole, "head_dim": by_hd, "whole": whole}[layout]
    k, v = constrain(k, kv_spec), constrain(v, kv_spec)

    def on_model(t, p) -> list:
        """t's placements with `p` on ``model``."""
        return [p if n == "model" else x for n, x in zip(names, t.placements)]

    if k.placements != v.placements or on_model(k, None) != on_model(q, None):
        raise NotImplementedError(f"q {q.placements}, k {k.placements} and v {v.placements} "
                                  "have no common batch layout for attention")

    psum = None
    if layout == "heads":
        lcfg = dataclasses.replace(cfg, n_heads=nq_l, n_kv_heads=nkv // m)
        ql, kl, vl = local_shard(q), local_shard(k), local_shard(v)
    elif layout == "kv_gathered":
        c = dm.get_local_rank("model")
        lo, hi = c * nq_l // g, ((c + 1) * nq_l - 1) // g + 1
        lcfg = dataclasses.replace(cfg, n_heads=nq_l, n_kv_heads=hi - lo)
        ql = local_shard(q)
        kl, vl = (local_shard(t, on_model(t, Partial()))[:, :, lo:hi] for t in (k, v))
    else:
        lcfg, (ql, kl, vl) = cfg, (local_shard(t) for t in (q, k, v))
    if layout == "head_dim":
        partial, summed = on_model(q, Partial()), on_model(q, Replicate())

        def psum(scores):  # dim 0 is the batch, as in q
            # every rank uses the summed scores with its own head_dim block
            # of v, so their gradient is a partial sum over ``model``
            return (DTensor.from_local(scores, dm, partial, run_check=False)
                    .redistribute(dm, summed).to_local(grad_placements=partial))

    out = fn(lcfg, ql, kl, vl, psum).contiguous()
    full = (q.shape[0], q.shape[1], nq, cfg.head_dim)
    return DTensor.from_local(out, dm, q.placements, run_check=False, shape=torch.Size(full),
                              stride=contiguous_stride(full))


def _gqa_scores(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, psum=None) -> torch.Tensor:
    """q: (B,T,nq,hd), k: (B,S,nkv,hd) -> (B,nkv,g,T,S) fp32 logits.

    The products of the compute-dtype operands are exact in float32, so
    scoring the float32 copies equals JAX's float32 accumulation.  `psum`,
    where given, sums the products of a head_dim shard over the ranks
    (:func:`_per_shard`); the scale is that of the whole head_dim."""
    b, t, nq, hd = q.shape
    qg = q.reshape(b, t, cfg.n_kv_heads, cfg.q_per_kv, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B, nkv, 1, hd, S)
    scores = qg.float() @ kt.float()
    if psum is not None:
        scores = psum(scores)
    scores = scores / math.sqrt(cfg.head_dim)
    return layers.softcap(scores, cfg.attn_softcap)


def _attend(cfg: ModelConfig, q, k, v, mask, psum=None) -> torch.Tensor:
    """mask: broadcastable to (B, nkv, g, T, S) bool (True = visible)."""
    scores = _gqa_scores(cfg, q, k, psum)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    b, t = q.shape[0], q.shape[1]
    out = probs.to(v.dtype) @ v.permute(0, 2, 1, 3)[:, :, None]  # (B, nkv, g, T, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, cfg.n_heads, v.shape[-1])


def _causal_mask(t: int, s: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = i >= j
    if window:
        m &= (i - j) < window
    return m  # (T, S)


def _attend_blocked(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int = 0,
    psum=None,
) -> torch.Tensor:
    """Flash-style blocked attention with online softmax.

    An outer loop over query blocks, an inner loop over KV blocks doing
    the online-softmax update; transient memory is O(bq * bkv) scores
    instead of O(T * S).  KV blocks wholly in a query block's future or
    wholly beyond its window are skipped, as in the JAX package's
    unrolled form.  Its scanned form visits them, and the result is the
    same: a masked block after a visible one adds exp(NEG_INF - m) = 0,
    and one before every visible block is scaled by exp(NEG_INF - m) = 0
    when the first visible block arrives.  `psum` is :func:`_gqa_scores`'s.
    """
    b, t, nq, hd = q.shape
    s = k.shape[1]
    nkv, g = cfg.n_kv_heads, cfg.q_per_kv
    bq = min(cfg.attn_block_q, t)
    bkv = min(cfg.attn_block_kv, s)
    if t % bq or s % bkv:
        raise ValueError(f"blocked attention needs whole blocks: T={t}, bq={bq}, S={s}, bkv={bkv}")
    scale = 1.0 / torch.sqrt(torch.tensor(float(cfg.head_dim)))
    qs = q.reshape(b, t // bq, bq, nkv, g, hd).float()
    kf, vt = k.float(), v.dtype
    dev = q.device
    outs = []
    for qb in range(t // bq):
        q_blk = qs[:, qb]
        q_pos = qb * bq + torch.arange(bq, device=dev)
        acc = torch.zeros((b, bq, nkv, g, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, bq, nkv, g), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, bq, nkv, g), dtype=torch.float32, device=dev)
        for kb in range(s // bkv):
            if causal and kb * bkv >= (qb + 1) * bq:
                continue  # entirely in the future
            if window and (kb + 1) * bkv <= qb * bq - window:
                continue  # entirely beyond the window
            k_blk = kf[:, kb * bkv:(kb + 1) * bkv]
            v_blk = v[:, kb * bkv:(kb + 1) * bkv]
            kv_pos = kb * bkv + torch.arange(bkv, device=dev)
            scores = torch.einsum("btngh,bsnh->btngs", q_blk, k_blk)  # (B, bq, nkv, g, bkv)
            if psum is not None:
                scores = psum(scores)
            scores = layers.softcap(scores * scale, cfg.attn_softcap)
            mask = torch.ones((bq, bkv), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= kv_pos[None, :]
            if window:
                mask &= (q_pos[:, None] - kv_pos[None, :]) < window
            scores = torch.where(mask[None, :, None, None, :], scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "btngs,bsnh->btngh", p.to(vt).float(), v_blk.float()
            )
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=1)
    return out.reshape(b, t, nq, hd).to(vt)


def _out_proj(p: dict, attn_out: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("btnh,nhd->btd")."""
    wo = p["wo"].to(dtype)
    if is_dtensor(attn_out) and any(q.is_shard(3) for q in attn_out.placements):
        return _out_proj_per_shard(attn_out, wo)
    return attn_out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _out_proj_per_shard(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`_out_proj` of an attention output sharded on its head_dim
    (``_per_shard``'s head_dim layout), on each rank's shards: torch 2.11
    refuses the flatten of (heads, head_dim) with head_dim sharded.  Each
    rank multiplies its head_dim block by the same block of ``wo``'s rows
    (gathered over its other dims), and the partial outputs are summed
    over the ranks that split head_dim (a row-parallel product)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = x.device_mesh
    x_pl = [p if p.is_shard(0) or p.is_shard(3) else Replicate() for p in x.placements]
    w_pl = [Shard(1) if p.is_shard(3) else Replicate() for p in x_pl]
    x, w = x.redistribute(dm, x_pl), w.redistribute(dm, w_pl)
    xl = local_shard(x)
    wl = local_shard(w, [Partial() if p.is_shard(0) else q for p, q in zip(x_pl, w_pl)])
    yl = xl.flatten(-2) @ wl.reshape(-1, wl.shape[-1])
    out = [Partial() if p.is_shard(3) else p for p in x_pl]
    shape = torch.Size((*x.shape[:2], w.shape[-1]))
    y = DTensor.from_local(yl, dm, out, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    return y.redistribute(dm, [Replicate() if p.is_partial() else p for p in out])


def _use_blocked(cfg: ModelConfig, t: int) -> bool:
    return t >= cfg.attn_block_threshold and t % cfg.attn_block_q == 0


def self_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    local: bool,
    mode: str,
    cache: dict | None = None,
    pos: torch.Tensor | None = None,
    max_len: int = 0,
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention in all three modes.

    train:   full sequence, causal (+window) mask, no cache.
    prefill: like train but returns a cache sized for decode.
    decode:  x is (B, 1, D); cache holds (B, S_cache, nkv, hd); `pos` is
             the absolute position of the new token (a 0-d int32 tensor),
             and the new K/V are written into the cache in place.
    """
    dt = x.dtype
    base = cfg.rope_base if local or cfg.rope_base_global is None else cfg.rope_base_global
    window = cfg.window_size if local else 0

    if mode in ("train", "prefill"):
        q, k, v = _project_qkv(cfg, p, x, x)
        if cfg.use_rope:
            q = layers.rope(q, positions, base)
            k = layers.rope(k, positions, base)
        t = x.shape[1]
        if _use_blocked(cfg, t):
            out = _per_shard(cfg, lambda c, q, k, v, psum: _attend_blocked(
                c, q, k, v, causal=True, window=window, psum=psum), q, k, v)
        else:
            mask = _causal_mask(t, t, window, x.device)[None, None, None]
            out = _per_shard(cfg, lambda c, q, k, v, psum: _attend(c, q, k, v, mask, psum),
                             q, k, v)
        y = _out_proj(p, out, dt)
        if mode == "train":
            return y, None
        # Decode cache.  Local layers keep a rolling window: slot of
        # absolute position p is p % window; for t >= window, slot s
        # holds position t - window + ((s - t) % window).
        if window and t >= window:
            src = t - window + (torch.arange(window, device=x.device) - t) % window
            return y, {"k": k[:, src], "v": v[:, src]}
        # pad to the decode budget (global) or the window (local): decode
        # writes at slots >= t
        slots = window or max(max_len, t)
        k_c = k.new_zeros((k.shape[0], slots, *k.shape[2:]))
        v_c = v.new_zeros((v.shape[0], slots, *v.shape[2:]))
        k_c[:, :t] = k
        v_c[:, :t] = v
        return y, {"k": k_c, "v": v_c}

    if cache is None or pos is None:
        raise ValueError("decode needs the layer's cache and the position")
    q, k_new, v_new = _project_qkv(cfg, p, x, x)
    if cfg.use_rope:
        pos_b = pos.reshape(1, 1)  # (1, T=1), broadcasts over batch
        q = layers.rope(q, pos_b, base)
        k_new = layers.rope(k_new, pos_b, base)
    k, v = cache["k"], cache["v"]
    slot = (pos % window if window else pos).reshape(1).long()
    _write_row(k, slot, k_new)
    _write_row(v, slot, v_new)
    j = torch.arange(k.shape[1], device=x.device)
    if window:
        valid = j < torch.clamp(pos + 1, max=window)  # filled rolling slots
    else:
        valid = j <= pos
    mask = valid[None, None, None, None, :]
    out = _per_shard(cfg, lambda c, q, k, v, psum: _attend(c, q, k, v, mask, psum),
                     q, k.to(dt), v.to(dt))
    return _out_proj(p, out, dt), {"k": k, "v": v}


def _write_row(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """Write the (B, 1, nkv, hd) row `new` into `cache` at `slot` of dim 1,
    in place.  On a mesh each rank writes its own shard: the cache's
    sequence dim is never sharded (``decode_state_axes``), so the row laid
    out as the cache is the rank's part of it."""
    if is_dtensor(cache):
        row = new.to(cache.dtype).redistribute(cache.device_mesh, cache.placements).to_local()
        cache.to_local().index_copy_(1, slot.to_local() if is_dtensor(slot) else slot, row)
    else:
        cache.index_copy_(1, slot, new.to(cache.dtype))


def cross_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    mode: str,
    ctx: torch.Tensor | None = None,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Cross-attention to a fixed context (stub image/frame embeddings).

    No RoPE, no causal mask.  prefill computes and caches the context
    K/V; decode reuses them unchanged.  The output is gated by
    tanh(gate), which opens at 0.  On a mesh the context is laid out over
    the batch axes as x is, and the heads attend per shard (:func:`_per_shard`).
    """
    dt = x.dtype
    if mode in ("train", "prefill"):
        if ctx is None:
            raise ValueError("cross-attention needs a context: batch['ctx'] of (B, n_ctx, D)")
        q, k, v = _project_qkv(cfg, p, x, ctx.to(dt))
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    else:
        if cache is None:
            raise ValueError("cross-attention decode needs the context cache")
        q = _proj(x, p["wq"].to(dt))
        if cfg.qk_norm:
            q = layers.rms_norm(q, p["q_norm"])
        k, v = cache["k"].to(dt), cache["v"].to(dt)
        new_cache = cache
    t = q.shape[1]
    if _use_blocked(cfg, t):
        out = _per_shard(cfg, lambda c, q, k, v, psum: _attend_blocked(
            c, q, k, v, causal=False, psum=psum), q, k, v)
    else:
        mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=x.device)
        out = _per_shard(cfg, lambda c, q, k, v, psum: _attend(c, q, k, v, mask, psum), q, k, v)
    y = _out_proj(p, out, dt)
    gate = torch.tanh(p["gate"].float()).to(dt)
    return y * gate, new_cache


def init_self_cache(
    cfg: ModelConfig, batch: int, s_max: int, *, local: bool, dtype, device=None
) -> dict[str, Any]:
    s = min(s_max, cfg.window_size) if (local and cfg.window_size) else s_max
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cross_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> dict[str, Any]:
    shape = (batch, cfg.n_ctx_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
