"""Meshes of devices and the rules that place the HDC state and the LM
parameters on them."""

from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingRules,
    abstract_params,
    constrain,
    constrain_batch,
    get_current_mesh,
    set_current_mesh,
)
