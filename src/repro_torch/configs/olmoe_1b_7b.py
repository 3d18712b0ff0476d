"""olmoe-1b-7b [moe] — arXiv:2409.02060 (hf-verified).

16L d_model=2048 16H (kv=16) vocab=50304; MoE 64 experts top-8,
d_ff/expert=1024.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=2,
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=50_304,
    ffn_kind="moe",
    moe_experts=64,
    moe_topk=8,
    moe_dff=1024,
    moe_impl="local",  # shard_map EP dispatch (see EXPERIMENTS.md §Perf)
    act="swiglu",
    qk_norm=True,
    tie_embeddings=False,
    loss_seq_chunks=4,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    vocab_size=512, moe_experts=8, moe_topk=2, moe_dff=32,
    moe_capacity=8.0,  # dropless at smoke sizes: decode must match train
    loss_seq_chunks=1, remat=False,
)
