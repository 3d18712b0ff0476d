"""llama-3.2-vision-90b [vlm] — hf:meta-llama/Llama-3.2-*-Vision (unverified).

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th
layer is gated cross-attention to vision patch embeddings.  The vision
tower is a stub per the assignment: input_specs() supplies precomputed
patch embeddings (B, 4096, d_model).  FSDP is required: 180 GB bf16
params -> 0.7 GB/device on the 256-chip pod with 2-D sharding.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=8,
    name="llama-3.2-vision-90b",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    act="swiglu",
    layer_pattern=("attn", "attn", "attn", "attn", "cross"),
    n_ctx_tokens=4096,
    tie_embeddings=False,
    fsdp=True,
    loss_seq_chunks=8,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, n_ctx_tokens=16, loss_seq_chunks=1, remat=False,
)
