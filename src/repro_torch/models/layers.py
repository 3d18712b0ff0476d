"""Shared neural-net primitives (pure functions, bf16-compute/fp32-param).

The torch counterpart of ``repro.models.layers``, with its dtype
choreography: norms and rotary phases in float32, cast back to the
input's dtype; matmuls in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., T, H, hd); positions: broadcastable (..., T)."""
    half = x.shape[-1] // 2
    freq = float(base) ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.float()[..., None] * freq  # (..., T, half)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh form (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def ffn(params: dict, x: torch.Tensor, act: str, dtype: torch.dtype) -> torch.Tensor:
    """Dense FFN: swiglu / geglu / gelu."""
    up = x @ params["w_up"].to(dtype)
    if act in ("swiglu", "geglu"):
        gate = x @ params["w_gate"].to(dtype)
        hidden = (F.silu(gate) if act == "swiglu" else gelu(gate)) * up
    else:
        hidden = gelu(up)
    return hidden @ params["w_down"].to(dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal positional embeddings (musicgen backbone), float32."""
    half = d // 2
    freq = 10_000.0 ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
