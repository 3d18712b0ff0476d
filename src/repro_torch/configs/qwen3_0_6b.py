"""qwen3-0.6b [dense] — hf:Qwen/Qwen3-8B family (hf-verified).

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; qk-norm,
head_dim=128 (decoupled), SwiGLU, tied embeddings.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=2,
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    act="swiglu",
    qk_norm=True,
    tie_embeddings=True,
    loss_seq_chunks=8,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, loss_seq_chunks=1, remat=False,
)
