"""recurrentgemma-2b [hybrid] — Griffin, arXiv:2402.19427 (hf-verified).

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000; pattern
(rec, rec, attn) — RG-LRU recurrent mixers with temporal conv4 + local
attention window 2048; GeGLU MLP.  26 = 8 periods + 2 tail rec layers.
Recurrent state is O(1) in sequence length -> runs long_500k.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=4,
    name="recurrentgemma-2b",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    act="geglu",
    embed_scale=True,
    layer_pattern=("rec", "rec", "attn"),
    window_size=2048,
    rec_width=2560,
    conv_width=4,
    tie_embeddings=True,
    loss_seq_chunks=16,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, window_size=8, rec_width=64,
    loss_seq_chunks=1, remat=False,
)
