"""qwen3-32b [dense] — hf:Qwen/Qwen3 family (hf-verified).

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936; qk-norm,
SwiGLU, untied head.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=8,
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151_936,
    act="swiglu",
    qk_norm=True,
    tie_embeddings=False,
    loss_seq_chunks=8,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=512, loss_seq_chunks=1, remat=False,
)
