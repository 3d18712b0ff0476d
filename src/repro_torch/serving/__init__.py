"""repro_torch.serving — packed-hypervector HDC inference service.

The torch counterpart of ``repro.serving``: checkpointed `HDCModel`s are
packed once into int32 class words and served through the hand-written
CUDA kernels (the plain versions on the CPU) behind a slot-based
continuous micro-batcher, with a multi-model registry that hot-reloads
newer checkpoint steps without dropping queued requests.  On a card
the static-shape step of an engine is a CUDA graph
(:mod:`repro_torch.serving.engine`).

    registry = ModelRegistry()
    batcher  = registry.register_checkpoint("uhd", "ckpt/", batch_size=64, start=True)
    label    = batcher.submit(image).result(timeout=1.0)

Execution placement is a pluggable layer: an engine runs on one device
or D-sharded over a mesh (`repro_torch.serving.execution`), and a
`ReplicaPool` fans one registry entry over N replicas with least-loaded
dispatch:

    pool = registry.register_checkpoint(
        "uhd", "ckpt/", replicas=4, placement="auto", start=True)

CLI driver: ``python -m repro_torch.launch.serve_hdc --smoke``.
"""

from repro_torch.serving.batcher import MicroBatcher, QueueFull, ServingFuture  # noqa: F401
from repro_torch.serving.engine import ServingEngine, resolve_impl  # noqa: F401
from repro_torch.serving.execution import (  # noqa: F401
    PLACEMENTS,
    DeviceExecution,
    ShardedExecution,
    plan_executions,
)
from repro_torch.serving.metrics import ServingMetrics  # noqa: F401
from repro_torch.serving.pool import ReplicaPool  # noqa: F401
from repro_torch.serving.registry import ModelRegistry  # noqa: F401
