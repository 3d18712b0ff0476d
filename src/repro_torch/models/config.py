"""Model configuration for the assigned LM-family architectures.

The torch counterpart of ``repro.models.config`` (a copy: the port imports
nothing of the JAX package).  A config fully determines parameter shapes, the per-layer block pattern
(mixer kind per position of a repeating period), and the sharding
personality.  Layer stacks are scanned over homogeneous *groups* (one
period each); a non-dividing remainder becomes an unscanned tail.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

MixerKind = Literal["attn", "local", "cross", "rec", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # 0 => no FFN sub-block (xLSTM)
    vocab_size: int

    # block pattern: mixer kinds for one period; tiled over n_layers.
    layer_pattern: tuple[MixerKind, ...] = ("attn",)
    # FFN flavour: "dense" everywhere, or "moe" (all layers MoE).
    ffn_kind: Literal["dense", "moe", "none"] = "dense"
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"

    # attention details
    # blocked (flash-style online-softmax) attention kicks in when the
    # KV length is >= attn_block_threshold; bounds score memory to
    # (B, H, T, block_kv) instead of (B, H, T, S).
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    attn_block_threshold: int = 4096
    qk_norm: bool = False
    attn_softcap: float | None = None
    use_rope: bool = True  # musicgen backbone uses sinusoidal abs-pos only
    rope_base: float = 10_000.0
    rope_base_global: float | None = None  # gemma3: different base on globals
    window_size: int = 0  # sliding window for "local" mixers

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_dff: int = 0
    moe_capacity: float = 1.25
    moe_aux_coef: float = 0.01
    # "gspmd": global sort-dispatch, compiler-partitioned (baseline).
    # "local": shard_map dispatch — tokens never leave their data shard;
    #   expert groups cross the model axis with two all-to-alls (the
    #   production EP pattern; see EXPERIMENTS.md section Perf).
    moe_impl: str = "gspmd"

    # RG-LRU (Griffin) recurrent mixer
    rec_width: int = 0
    conv_width: int = 4

    # xLSTM
    xlstm_proj_factor: float = 2.0
    chunk_size: int = 256

    # VLM cross-attention
    n_ctx_tokens: int = 0  # stub image/frame context length

    # embedding / head
    input_mode: Literal["tokens", "embeddings"] = "tokens"
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    tie_embeddings: bool = True
    logit_softcap: float | None = None

    # execution.  grad_accum, unroll_loops, remat, remat_policy, fsdp and
    # loss_seq_chunks steer the JAX package's training and lowering; the
    # port keeps them so that every config equals its JAX twin field for
    # field, and its forward path reads none of them.
    grad_accum: int = 1
    # stack the layer groups on a leading axis (False: every layer in the tail)
    scan_layers: bool = True
    unroll_loops: bool = False
    remat: bool = True
    remat_policy: str = "nothing"
    param_dtype: str = "float32"  # training master dtype
    compute_dtype: str = "bfloat16"
    fsdp: bool = False  # additionally shard big params over the data axis
    loss_seq_chunks: int = 1  # chunk the unembed+CE over seq (big vocab)

    # --- derived ---------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.period if self.scan_layers else 0

    @property
    def tail_pattern(self) -> tuple[MixerKind, ...]:
        """Unscanned layers: the full stack when scan_layers=False, else
        the remainder that does not fill a whole period."""
        if not self.scan_layers:
            return tuple(
                self.layer_pattern[i % self.period] for i in range(self.n_layers)
            )
        rem = self.n_layers - self.n_groups * self.period
        return self.layer_pattern[:rem]

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def rec_dim(self) -> int:
        return self.rec_width or self.d_model

    @property
    def xlstm_inner(self) -> int:
        return int(self.d_model * self.xlstm_proj_factor)

    @property
    def xlstm_head_dim(self) -> int:
        return self.xlstm_inner // self.n_heads

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def mixer_for_layer(self, layer: int) -> MixerKind:
        return self.layer_pattern[layer % self.period]

    def n_params(self) -> int:
        """Total parameter count (exact, from the spec tree)."""
        from repro_torch.models import params as p  # local: avoid import cycle

        return sum(math.prod(s.shape) for s in p.flatten_specs(p.param_specs(self)))

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        total = self.n_params()
        if self.ffn_kind != "moe":
            return total
        from repro_torch.models import params as p

        expert_like = sum(
            math.prod(s.shape)
            for s in p.flatten_specs(p.param_specs(self))
            if "experts" in (s.axes or ())
        )
        active = expert_like * self.moe_topk // self.moe_experts
        return total - expert_like + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Archs for which long_500k is runnable (sub-quadratic / bounded-KV):
# recurrentgemma (RG-LRU + windowed attn), xlstm (linear), gemma3 (5:1
# local:global — only 8/48 layers hold full-context KV).  Pure
# full-attention archs skip it (see DESIGN.md §4).
LONG_CONTEXT_OK = {"recurrentgemma-2b", "xlstm-1.3b", "gemma3-12b"}
