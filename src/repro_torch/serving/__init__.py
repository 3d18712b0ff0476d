"""repro_torch.serving — packed-hypervector HDC inference on one device
or D-sharded over a mesh of devices."""

from repro_torch.serving.engine import ServingEngine, resolve_impl  # noqa: F401
from repro_torch.serving.execution import (  # noqa: F401
    PLACEMENTS,
    DeviceExecution,
    ShardedExecution,
    plan_executions,
)
