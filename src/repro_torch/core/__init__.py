"""uHD core of the port: Sobol numbers, packed bits, the ``uhd``,
``uhd_dynamic`` and ``baseline`` encoders, `HDCModel` (and its D-sharded
form), the trainers' helpers and `ItemMemory`."""

from repro_torch.core.model import HDCConfig  # noqa: F401
from repro_torch.core.hdc_model import (  # noqa: F401
    HDCModel,
    ShardedHDCModel,
    baseline_iterative_search,
    partial_fit_sharded,
    predict_packed,
    resolve_device,
    search_packed,
    train_and_eval,
)
from repro_torch.core.item_memory import ItemMemory  # noqa: F401
from repro_torch.core.registry import (  # noqa: F401
    BackendUnavailableError,
    backend_names,
    get_encoder,
    resolve_backend,
)
from repro_torch.core import encoders as _builtin_encoders  # noqa: F401  (registers)
