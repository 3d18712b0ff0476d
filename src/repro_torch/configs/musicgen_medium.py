"""musicgen-medium [audio] — arXiv:2306.05284 (hf-verified).

48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048; decoder-only
transformer over EnCodec tokens.  Backbone only per the assignment:
the EnCodec frontend is a stub — input_specs() supplies precomputed
frame embeddings (sum of the 4 codebook embeddings); sinusoidal
positions; GELU FFN; separate 2048-way head (one codebook stream).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=4,
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    use_rope=False,
    input_mode="embeddings",
    tie_embeddings=False,
    loss_seq_chunks=1,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=128, remat=False,
)
