"""gemma-7b [dense] — arXiv:2403.08295 (hf-verified).

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000; GeGLU,
head_dim=256 (decoupled from d_model/H), embeddings scaled by sqrt(d),
tied vocab head.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=4,
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    loss_seq_chunks=16,  # 256k vocab: chunk the unembed+CE
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, loss_seq_chunks=1, remat=False,
)
