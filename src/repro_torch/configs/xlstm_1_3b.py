"""xlstm-1.3b [ssm] — arXiv:2405.04517 (unverified tier).

48L d_model=2048 4 heads vocab=50304, d_ff=0 (xLSTM blocks carry their
own up/down projections; no separate FFN).  Pattern: 7 mLSTM blocks
then 1 sLSTM per period (paper's [7:1] ratio).  mLSTM uses projection
factor 2 (inner=4096 -> per-head matrix memory 1024x1024); assignment's
head_dim=512 (= d_model/heads) applies to the nominal attention-free
geometry.  Linear-time state -> runs long_500k.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    grad_accum=4,
    name="xlstm-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    ffn_kind="none",
    vocab_size=50_304,
    layer_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm_proj_factor=2.0,
    chunk_size=256,
    tie_embeddings=True,
    loss_seq_chunks=4,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    vocab_size=512, chunk_size=4, loss_seq_chunks=1, remat=False,
)
