"""uHD core of the port: Sobol numbers, packed bits, the ``uhd``,
``uhd_dynamic`` and ``baseline`` encoders, `HDCModel` (and its D-sharded
form), the trainers' helpers and `ItemMemory`.

The flat functions of the JAX package's first API (``build_codebooks``,
``encode``, ``fit``, ...) are not here: accessing them raises an
``AttributeError`` naming the ``HDCModel`` replacement, as in
``repro.core``."""

from repro_torch.core.model import (  # noqa: F401
    HDCConfig,
    baseline_iterative_search,
    train_and_eval,
)
from repro_torch.core.hdc_model import (  # noqa: F401
    HDCModel,
    ShardedHDCModel,
    partial_fit_sharded,
    predict_packed,
    resolve_device,
    search_packed,
)
from repro_torch.core.item_memory import ItemMemory  # noqa: F401
from repro_torch.core.registry import (  # noqa: F401
    BackendUnavailableError,
    Encoder,
    EncoderBase,
    backend_names,
    encoder_names,
    get_encoder,
    register_backend,
    register_encoder,
    register_fit_bundle,
    register_topk,
    resolve_backend,
)
from repro_torch.core import encoders as _builtin_encoders  # noqa: F401  (registers)


def __getattr__(name: str):
    """Removed flat-API names get the same helpful tombstone as
    :mod:`repro_torch.core.model` (the JAX package re-exported them here)."""
    from repro_torch.core import model as _model

    if name in _model._REMOVED_FLAT_API:
        return getattr(_model, name)  # raises the helpful AttributeError
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
