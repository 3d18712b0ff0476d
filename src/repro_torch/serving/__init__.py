"""repro_torch.serving — packed-hypervector HDC inference on one device."""

from repro_torch.serving.engine import ServingEngine, resolve_impl  # noqa: F401
from repro_torch.serving.execution import DeviceExecution  # noqa: F401
