"""gemma3-12b [dense] — hf:google/gemma-3 family (unverified tier).

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144; 5:1
local:global attention (sliding window 1024 on locals), RoPE base 10k
local / 1M global, 128k-class context.  The 5:1 pattern is why this
arch runs the long_500k cell: only 8/48 layers hold full-context KV.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=8,
    name="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262_144,
    act="geglu",
    embed_scale=True,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    window_size=1024,
    rope_base=10_000.0,
    rope_base_global=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    loss_seq_chunks=16,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, window_size=8, loss_seq_chunks=1, remat=False,
)
