"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential recurrence) — Beck et al., arXiv:2405.04517.

The torch counterpart of ``repro.models.xlstm``.  mLSTM stabilized
semantics (per head; stored state is m-stabilized):
    m_t = max(log f_t + m_{t-1}, itil_t)
    C_t = e^{log f_t + m_{t-1} - m_t} C_{t-1} + e^{itil_t - m_t} k_t v_t^T
    n_t = e^{log f_t + m_{t-1} - m_t} n_{t-1} + e^{itil_t - m_t} k_t
    h_t = (q_t^T C_t) / max(|q_t . n_t|, e^{-m_t})

Training/prefill uses the chunkwise-parallel form: a loop over chunks of
`chunk_size` carrying (C, n, m); intra-chunk terms form an (L, L)
decay-masked attention matrix.  `mlstm_step` is the exact stepwise
recurrence.  sLSTM has true hidden-to-gate recurrence (R h_{t-1}): a
loop over steps, O(T) depth, O(1) state.

On a mesh (x a ``DTensor``) both blocks run on each rank's batch shard and
its block of the heads (``per_shard``): the chunkwise mLSTM and the
sLSTM's loop over steps are per head, so each runs on local tensors with
no collective inside.  The mLSTM's weights keep the rules' layout: the
rank's block of ``inner`` is all-gathered for its q, k, v and gates, which
contract over all of it, and the output gate's partial products (``w_o``
by the rows of that block) are reduce-scattered to its heads' columns;
``w_down`` and the sLSTM's ``w_out`` are taken by the rows of its heads,
whose partial outputs are all-reduced.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.per_shard import Shards

NEG_INF = -1e30
#: the heads dim of each leaf and each state (``per_shard``); None: taken whole
_MLSTM_DIMS = {"w_in": 1, "w_q": 1, "w_k": 1, "w_v": 1, "w_i": 1, "b_i": 0, "w_f": 1,
               "b_f": 0, "w_o": 0, "h_norm": None, "w_down": 0}
_MLSTM_STATE_DIMS = {"c": 1, "n": 1, "m": 1}
_SLSTM_DIMS = {"w_x": 2, "r_h": 1, "b": 1, "h_norm": None, "w_out": 0}
_SLSTM_STATE_DIMS = {"c": 1, "n": 1, "m": 1, "h": 1}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bti,inh->btnh")."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _mlstm_qkvif(cfg: ModelConfig, p: dict, x: torch.Tensor, sh: Shards | None = None):
    """x: (B, T, D) -> q,k,v (B,T,nh,hd) fp32; itil,logf (B,T,nh) fp32; o gate; inner.
    `sh`, on a mesh: ``inner`` is this rank's block, gathered for q, k, v
    and the gates, and the output gate's partial products are summed and
    split to the rank's heads."""
    dt = x.dtype
    inner = x @ p["w_in"].to(dt)  # (B, T, inner)
    o_pre = inner @ p["w_o"].to(dt)
    innf = inner.float()
    if sh is not None:  # the float32 operand of JAX's q, k, v and gate products
        innf, o_pre = sh.gather(innf), sh.sum_scatter(o_pre)
    q = _heads(innf, p["w_q"].float())
    k = _heads(innf, p["w_k"].float())
    v = _heads(innf, p["w_v"].float())
    q = q / math.sqrt(q.shape[-1])
    itil = innf @ p["w_i"].float() + p["b_i"].float()
    ftil = innf @ p["w_f"].float() + p["b_f"].float()
    logf = F.logsigmoid(ftil)  # (B, T, nh)
    o = torch.sigmoid(o_pre)  # (B, T, inner)
    return q, k, v, itil, logf, o, inner


def _mlstm_out(cfg: ModelConfig, p: dict, h: torch.Tensor, o: torch.Tensor, dt):
    """h: (B,T,nh,hd) fp32 -> output (B,T,D)."""
    b, t, nh, hd = h.shape
    h = layers.rms_norm(h, p["h_norm"])  # per-head norm
    h = h.reshape(b, t, nh * hd).to(dt) * o
    return h @ p["w_down"].to(dt)


def _chunk_step(carry, qj, kj, vj, ij, fj):
    """One chunk of the chunkwise form; inputs (B, ck, nh, ...)."""
    c_prev, n_prev, m_prev = carry
    ck = qj.shape[1]
    fcum = torch.cumsum(fj, dim=1)  # F_j inclusive, (B, ck, nh)
    ftot = fcum[:, -1]  # (B, nh)
    fcum_t = fcum.transpose(1, 2)  # (B, nh, ck)

    # intra-chunk log weights: Dmat[j,s] = F_j - F_s + itil_s for s<=j
    dmat = fcum_t[:, :, :, None] - fcum_t[:, :, None, :] + ij.transpose(1, 2)[:, :, None, :]
    causal = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=qj.device))
    dmat = torch.where(causal[None, None], dmat, NEG_INF)

    m_intra = dmat.amax(-1)  # (B, nh, ck)
    m_inter = m_prev[:, :, None] + fcum_t  # (B, nh, ck)
    m_j = torch.maximum(m_inter, m_intra)

    # intra attention
    s_w = torch.exp(dmat - m_j[..., None])  # (B, nh, ck, ck)
    qk = torch.einsum("bjnh,bsnh->bnjs", qj, kj)
    h_intra = torch.einsum("bnjs,bsnh->bjnh", s_w * qk, vj)

    # inter (carried state) contribution
    w_inter = torch.exp(m_inter - m_j).transpose(1, 2)  # (B, ck, nh)
    h_inter = torch.einsum("bjnh,bnhg->bjng", qj, c_prev) * w_inter[..., None]

    # normalizer
    norm = (torch.einsum("bjnh,bnh->bjn", qj, n_prev) * w_inter
            + torch.einsum("bnjs,bsnh,bjnh->bjn", s_w, kj, qj))
    denom = torch.maximum(norm.abs(), torch.exp(-m_j).transpose(1, 2))
    h = (h_intra + h_inter) / denom[..., None]

    # chunk-end state update
    # decay of each in-chunk position to chunk end: G_s = F_L - F_s + itil_s
    g = ftot[:, None, :] - fcum + ij  # (B, ck, nh)
    m_end = torch.maximum(m_prev + ftot, g.amax(1))
    w_old = torch.exp(m_prev + ftot - m_end)  # (B, nh)
    w_new = torch.exp(g - m_end[:, None, :])  # (B, ck, nh)
    c_new = c_prev * w_old[..., None, None] + torch.einsum("bsnh,bsng,bsn->bnhg", kj, vj, w_new)
    n_new = n_prev * w_old[..., None] + torch.einsum("bsnh,bsn->bnh", kj, w_new)
    return (c_new, n_new, m_end), h


def mlstm_block(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict | None = None, *,
                mode: str):
    """The mLSTM mixer: chunkwise over a sequence (train, prefill; the
    prefill returns its state) or one step (decode)."""
    if is_dtensor(x):
        sh = Shards(x, cfg.n_heads)
        y, new = _mlstm(cfg, sh.weights(p, _MLSTM_DIMS), sh.x,
                        sh.states(state, _MLSTM_STATE_DIMS), mode=mode, sh=sh)
        return sh.out(y), sh.new_states(new, _MLSTM_STATE_DIMS)
    return _mlstm(cfg, p, x, state, mode=mode)


def _mlstm(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict | None, *, mode: str,
           sh: Shards | None = None):
    if mode == "decode":
        return mlstm_step(cfg, p, x, state, sh=sh)
    return mlstm_chunkwise(cfg, p, x, None, return_state=(mode == "prefill"), sh=sh)


def mlstm_chunkwise(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    state: dict | None = None,
    *,
    return_state: bool,
    sh: Shards | None = None,
):
    """Chunkwise-parallel mLSTM. x: (B, T, D)."""
    dt = x.dtype
    q, k, v, itil, logf, o, _ = _mlstm_qkvif(cfg, p, x, sh)
    b, t, nh, hd = q.shape
    ck = min(cfg.chunk_size, t)
    if t % ck:  # fall back to the largest divisor (odd test lengths)
        ck = max(c for c in range(1, ck + 1) if t % c == 0)

    if state is None:
        carry = init_mlstm_state_dims(b, nh, hd, q.device)
        carry = (carry["c"], carry["n"], carry["m"])
    else:
        carry = (state["c"], state["n"], state["m"])
    hs = []
    for s0 in range(0, t, ck):
        sl = slice(s0, s0 + ck)
        carry, hi = _chunk_step(carry, q[:, sl], k[:, sl], v[:, sl], itil[:, sl], logf[:, sl])
        hs.append(hi)
    h = torch.cat(hs, dim=1)
    out = _mlstm_out(cfg, p, h, o, dt)
    if return_state:
        c_f, n_f, m_f = carry
        return out, {"c": c_f, "n": n_f, "m": m_f}
    return out, None


def mlstm_step(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict,
               sh: Shards | None = None):
    """Exact stepwise mLSTM decode. x: (B, 1, D)."""
    dt = x.dtype
    q, k, v, itil, logf, o, _ = _mlstm_qkvif(cfg, p, x, sh)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]  # (B, nh, hd)
    itil, logf = itil[:, 0], logf[:, 0]  # (B, nh)
    c, n, m = state["c"], state["n"], state["m"]
    m_new = torch.maximum(logf + m, itil)
    w_old = torch.exp(logf + m - m_new)[..., None]
    w_new = torch.exp(itil - m_new)[..., None]
    c_new = c * w_old[..., None] + w_new[..., None] * k[..., :, None] * v[..., None, :]
    n_new = n * w_old + w_new * k
    num = torch.einsum("bnh,bnhg->bng", q, c_new)
    den = torch.maximum(torch.einsum("bnh,bnh->bn", q, n_new).abs(), torch.exp(-m_new))
    h = (num / den[..., None])[:, None]  # (B, 1, nh, hd)
    out = _mlstm_out(cfg, p, h, o, dt)
    return out, {"c": c_new, "n": n_new, "m": m_new}


def init_mlstm_state_dims(batch: int, nh: int, hd: int, device=None) -> dict:
    return {
        "c": torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return init_mlstm_state_dims(batch, cfg.n_heads, cfg.xlstm_head_dim, device)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_x(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Precompute input projections for all gates: (B, T, 4, nh, hd) fp32."""
    w = p["w_x"].float()
    xg = (x.float() @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    return xg + p["b"].float()


def _slstm_cell(p: dict, xg: torch.Tensor, state: dict) -> dict:
    """One sLSTM step.  xg: (B, 4, nh, hd); state: dict of (B, nh, hd)."""
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    rec = torch.einsum("bnh,gnkh->bgnk", h, p["r_h"].float())
    z = torch.tanh(xg[:, 0] + rec[:, 0])
    itil = xg[:, 1] + rec[:, 1]
    ftil = xg[:, 2] + rec[:, 2]
    og = torch.sigmoid(xg[:, 3] + rec[:, 3])
    logf = F.logsigmoid(ftil)
    m_new = torch.maximum(logf + m, itil)
    i_p = torch.exp(itil - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = og * c_new / torch.clamp(n_new, min=1e-9)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def slstm_block(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,
    state: dict | None = None,
    *,
    mode: str,
):
    """sLSTM over a sequence (a loop over steps) or one step (decode)."""
    if is_dtensor(x):
        sh = Shards(x, cfg.n_heads)
        y, new = _slstm(cfg, sh.weights(p, _SLSTM_DIMS), sh.x,
                        sh.states(state, _SLSTM_STATE_DIMS), mode=mode)
        return sh.out(y), sh.new_states(new, _SLSTM_STATE_DIMS)
    return _slstm(cfg, p, x, state, mode=mode)


def _slstm(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict | None, *, mode: str):
    dt = x.dtype
    b, t, _ = x.shape
    nh = p["w_x"].shape[2]  # this rank's heads on a mesh
    hd = cfg.d_model // cfg.n_heads
    if state is None:
        state = init_slstm_state_dims(b, nh, hd, x.device)
    xg = _slstm_x(p, x)  # (B, T, 4, nh, hd)

    if mode == "decode":
        state = _slstm_cell(p, xg[:, 0], state)
        h = state["h"][:, None]  # (B, 1, nh, hd)
    else:
        hs = []
        for i in range(t):
            state = _slstm_cell(p, xg[:, i], state)
            hs.append(state["h"])
        h = torch.stack(hs, dim=1)  # (B, T, nh, hd)
    h = layers.rms_norm(h, p["h_norm"]).flatten(2).to(dt)
    out = h @ p["w_out"].to(dt)
    if mode == "train":
        return out, None
    return out, state


def init_slstm_state_dims(batch: int, nh: int, hd: int, device=None) -> dict:
    z = torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)
    return {"c": z, "n": z + 1e-9, "m": torch.full((batch, nh, hd), -30.0, device=device),
            "h": z.clone()}


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return init_slstm_state_dims(batch, cfg.n_heads, cfg.d_model // cfg.n_heads, device)
