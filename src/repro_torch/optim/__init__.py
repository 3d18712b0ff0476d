"""AdamW, global-norm clipping and the learning-rate schedules."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptimizerConfig,
    adamw_step,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_at,
)
