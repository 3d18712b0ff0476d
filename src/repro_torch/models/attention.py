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

import math
from typing import Any

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG_INF = -2.0**30


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dnh->btnh"): x (B, T, D) @ w (D, n, h)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_src: torch.Tensor):
    dt = x.dtype
    q = _proj(x, p["wq"].to(dt))
    k = _proj(kv_src, p["wk"].to(dt))
    v = _proj(kv_src, p["wv"].to(dt))
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"])
        k = layers.rms_norm(k, p["k_norm"])
    return q, k, v


def _gqa_scores(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,T,nq,hd), k: (B,S,nkv,hd) -> (B,nkv,g,T,S) fp32 logits.

    The products of the compute-dtype operands are exact in float32, so
    scoring the float32 copies equals JAX's float32 accumulation."""
    b, t, nq, hd = q.shape
    qg = q.reshape(b, t, cfg.n_kv_heads, cfg.q_per_kv, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # (B, nkv, 1, hd, S)
    scores = qg.float() @ kt.float()
    scores = scores / math.sqrt(hd)
    return layers.softcap(scores, cfg.attn_softcap)


def _attend(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """mask: broadcastable to (B, nkv, g, T, S) bool (True = visible)."""
    scores = _gqa_scores(cfg, q, k)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    b, t = q.shape[0], q.shape[1]
    out = probs.to(v.dtype) @ v.permute(0, 2, 1, 3)[:, :, None]  # (B, nkv, g, T, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, cfg.n_heads, cfg.head_dim)


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
) -> torch.Tensor:
    """Flash-style blocked attention with online softmax.

    An outer loop over query blocks, an inner loop over KV blocks doing
    the online-softmax update; transient memory is O(bq * bkv) scores
    instead of O(T * S).  KV blocks wholly in a query block's future or
    wholly beyond its window are skipped, as in the JAX package's
    unrolled form.  Its scanned form visits them, and the result is the
    same: a masked block after a visible one adds exp(NEG_INF - m) = 0,
    and one before every visible block is scaled by exp(NEG_INF - m) = 0
    when the first visible block arrives.
    """
    b, t, nq, hd = q.shape
    s = k.shape[1]
    nkv, g = cfg.n_kv_heads, cfg.q_per_kv
    bq = min(cfg.attn_block_q, t)
    bkv = min(cfg.attn_block_kv, s)
    if t % bq or s % bkv:
        raise ValueError(f"blocked attention needs whole blocks: T={t}, bq={bq}, S={s}, bkv={bkv}")
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
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
    return attn_out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


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
            out = _attend_blocked(cfg, q, k, v, causal=True, window=window)
        else:
            mask = _causal_mask(t, t, window, x.device)[None, None, None]
            out = _attend(cfg, q, k, v, mask)
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
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))
    j = torch.arange(k.shape[1], device=x.device)
    if window:
        valid = j < torch.clamp(pos + 1, max=window)  # filled rolling slots
    else:
        valid = j <= pos
    mask = valid[None, None, None, None, :]
    out = _attend(cfg, q, k.to(dt), v.to(dt), mask)
    return _out_proj(p, out, dt), {"k": k, "v": v}


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
    tanh(gate), which opens at 0.
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
        out = _attend_blocked(cfg, q, k, v, causal=False)
    else:
        mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=x.device)
        out = _attend(cfg, q, k, v, mask)
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
