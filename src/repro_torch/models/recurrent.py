"""RG-LRU recurrent mixer (Griffin / RecurrentGemma).

The torch counterpart of ``repro.models.recurrent``.  Block structure
(De et al., arXiv:2402.19427):
    x -> [linear -> causal depthwise conv(4) -> RG-LRU] (.) [linear -> gelu]
      -> linear out

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_r xc_t + b_r)          recurrence gate
    i_t = sigmoid(W_i xc_t + b_i)          input gate
    log a_t = -c * softplus(lam) * r_t     (a = sigmoid(lam)^(c*r)), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xc_t)

Train/prefill runs the recurrence as a log-depth (Hillis-Steele) scan
over the sequence; JAX's ``lax.associative_scan`` combines in another
tree, so the two agree to float32 rounding, not bit for bit.  Decode is
a single step.  State per layer is (B, W), constant in sequence length.

On a mesh (x a ``DTensor``) the block runs on each rank's batch shard and
its block of the W channels (``per_shard``): the conv, the gates' scan and
the decode step are per channel; the gates' products with ``w_rx`` and
``w_ix``, whose rows are the rank's channels, are partial sums that are
reduce-scattered back to its channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.per_shard import Shards

_C = 8.0  # Griffin's fixed gate exponent
#: the W dim of each leaf and each state (``per_shard``)
_DIMS = {"w_in": 1, "w_gate_in": 1, "conv_w": 1, "conv_b": 0, "w_rx": 0, "b_rx": 0,
         "w_ix": 0, "b_ix": 0, "lam": 0, "w_out": 0}
_STATE_DIMS = {"h": 1, "conv": 2}


def _conv_causal(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width cw.  x: (B, T, W)."""
    cw = p["conv_w"].shape[0]
    dt = x.dtype
    out = torch.zeros_like(x)
    for i in range(cw):
        shift = cw - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, : x.shape[1]]
        out = out + xi * p["conv_w"][i].to(dt)
    return out + p["conv_b"].to(dt)


def _lru_coeffs(p: dict, xc: torch.Tensor, psum=None):
    """Gate math in fp32; returns (a, b) with h_t = a_t h + b_t.  `psum`,
    where given, sums the gates' partial products over the ranks that hold
    the other channels and keeps this rank's (``Shards.sum_scatter``)."""
    xf = xc.float()
    psum = psum or (lambda t: t)
    r = torch.sigmoid(psum(xf @ p["w_rx"].float()) + p["b_rx"].float())
    i = torch.sigmoid(psum(xf @ p["w_ix"].float()) + p["b_ix"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def rglru_scan(p: dict, xc: torch.Tensor, h0: torch.Tensor | None = None, psum=None):
    """Scan the linear recurrence over seq. xc: (B, T, W).

    Returns (y (B,T,W) fp32, h_last (B,W) fp32)."""
    a, h = _lru_coeffs(p, xc, psum)
    if h0 is not None:
        # Fold the carried state into the first step: h_1 = a_1 h0 + b_1.
        h = h.clone()
        h[:, 0] += a[:, 0] * h0.float()
    # Hillis-Steele: after the pass at offset d, (a_t, h_t) composes steps
    # t-2d+1 .. t; composing with the earlier span (a', h') gives
    # (a' a_t, a_t h' + h_t).
    t, d = a.shape[1], 1
    while d < t:
        h = torch.cat([h[:, :d], a[:, d:] * h[:, :-d] + h[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h, h[:, -1]


def rglru_step(p: dict, xc: torch.Tensor, h: torch.Tensor, psum=None):
    """One decode step. xc: (B, 1, W); h: (B, W) fp32."""
    a, b = _lru_coeffs(p, xc, psum)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new[:, None], h_new


def recurrent_block(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    *,
    mode: str,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """The full Griffin recurrent mixer.  state = {"h": (B,W), "conv": (B,cw-1,W)}."""
    if is_dtensor(x):
        sh = Shards(x, cfg.rec_dim)
        y, new = _block(cfg, sh.weights(p, _DIMS), sh.x, mode=mode,
                        state=sh.states(state, _STATE_DIMS), psum=sh.sum_scatter)
        return sh.out(y), sh.new_states(new, _STATE_DIMS)
    return _block(cfg, p, x, mode=mode, state=state)


def _block(cfg: ModelConfig, p: dict, x: torch.Tensor, *, mode: str, state: dict | None,
           psum=None) -> tuple[torch.Tensor, dict | None]:
    dt = x.dtype
    cw = cfg.conv_width
    xr = x @ p["w_in"].to(dt)  # (B, T, W)
    gate = layers.gelu(x @ p["w_gate_in"].to(dt))

    if mode in ("train", "prefill"):
        xc = _conv_causal(p, xr)
        y, h_last = rglru_scan(p, xc, psum=psum)
        out = (y.to(dt) * gate) @ p["w_out"].to(dt)
        if mode == "train":
            return out, None
        t = xr.shape[1]
        tail = xr[:, max(t - (cw - 1), 0):]
        if tail.shape[1] < cw - 1:
            tail = F.pad(tail, (0, 0, cw - 1 - tail.shape[1], 0))
        return out, {"h": h_last, "conv": tail}

    if state is None:
        raise ValueError("recurrent decode needs the layer's state")
    # decode: conv over the (cw-1) carried inputs + the new one
    hist = torch.cat([state["conv"].to(dt), xr], dim=1)  # (B, cw, W)
    xc = (torch.einsum("bcw,cw->bw", hist, p["conv_w"].to(dt)) + p["conv_b"].to(dt))[:, None]
    y, h_new = rglru_step(p, xc, state["h"], psum)
    out = (y.to(dt) * gate) @ p["w_out"].to(dt)
    return out, {"h": h_new, "conv": hist[:, 1:]}


def init_rec_state(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    w, cw = cfg.rec_dim, cfg.conv_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cw - 1, w), dtype=dtype, device=device),
    }
