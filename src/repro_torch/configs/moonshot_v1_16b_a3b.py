"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (hf-verified).

48L d_model=2048 16H (GQA kv=16) vocab=163840; MoE with 64 routed
experts, top-6, d_ff/expert=1408.  Experts shard over the "model" mesh
axis (EP); dispatch is sort-based with capacity (see models/moe.py).
Assignment config is routed-only (the HF checkpoint additionally has
2 shared experts and a dense first layer — out of scope per the
assignment line, noted here for provenance).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=4,
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=163_840,
    ffn_kind="moe",
    moe_experts=64,
    moe_topk=6,
    moe_dff=1408,
    moe_impl="local",  # shard_map EP dispatch: collective term 99x below gspmd (EXPERIMENTS.md §Perf)
    act="swiglu",
    tie_embeddings=True,
    loss_seq_chunks=8,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    vocab_size=512, moe_experts=8, moe_topk=2, moe_dff=32,
    moe_capacity=8.0,  # dropless at smoke sizes: decode must match train
    loss_seq_chunks=1, remat=False,
)
