"""`HDCConfig`: the static configuration of an HDC classifier.

The same fields, defaults and validation as ``repro.core.model.HDCConfig``
(less the deprecated ``use_kernels``/``encode_impl`` aliases), so a
config round-trips through a checkpoint manifest written by either
package.  Backend names differ between the packages: the port's
``"cuda"`` datapath is the JAX package's ``"pallas"`` where the JAX
encoder has one.  A manifest carries only a backend name that the JAX
package registers for the encoder, because the JAX package rejects any
other (:func:`manifest_config`).  The backend is a choice made
where a model runs, not model state: a manifest's backend reads back as
``"auto"`` (:func:`config_from_manifest`), so a checkpoint written with
either package's ``"ref"`` or ``"pallas"`` loads on a card and on the CPU.

It also keeps the JAX package's tombstone for the removed functional API
(``build_codebooks`` / ``encode`` / ``fit`` / ``fit_streaming`` /
``predict`` / ``evaluate``): the module ``__getattr__`` raises an
``AttributeError`` naming the ``HDCModel`` replacement for each, and the
``train_and_eval`` and ``baseline_iterative_search`` forwards to
:mod:`repro_torch.core.hdc_model`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

#: port backend name -> JAX package backend name
_TO_MANIFEST = {"cuda": "pallas"}
#: the JAX package's backend names per encoder (``repro.core.encoders``), a copy
_JAX_BACKENDS = {
    "uhd": ("naive", "blocked", "unary_matmul", "pallas", "unary_oracle"),
    "uhd_dynamic": ("ref", "pallas"),
    "baseline": ("naive", "unary_matmul"),
}
#: fields of the JAX config that are deprecated aliases folded into
#: ``backend``; older manifests may still carry them.
_LEGACY_FIELDS = ("use_kernels", "encode_impl")


@dataclasses.dataclass(frozen=True)
class HDCConfig:
    """Configuration of an HDC classifier (see ``repro.core.model``)."""

    n_features: int
    n_classes: int
    d: int = 8192  # hypervector dimensionality D
    levels: int = 16  # quantization levels (M = log2(levels) bits)
    encoder: str = "uhd"  # a registered encoder ("uhd", "uhd_dynamic", "baseline")
    seed: int = 0
    sobol_skip: int = 1
    class_binarize: str = "auto"  # "auto" | "sign" | "none"
    binarize_query: bool = False
    similarity: str = "cosine"  # "cosine" | "dot" | "hamming"
    pack_center: str = "auto"  # "auto" | "row" | "none"
    backend: str = "auto"  # "auto" | a registered backend ("cuda", "ref")
    max_intensity: float = 255.0

    def __post_init__(self):
        if self.levels & (self.levels - 1):
            raise ValueError("levels must be a power of two")
        if self.class_binarize not in ("auto", "sign", "none"):
            raise ValueError(f"unknown class_binarize {self.class_binarize!r}")
        if self.pack_center not in ("auto", "row", "none"):
            raise ValueError(f"unknown pack_center {self.pack_center!r}")
        from repro_torch.core import registry  # deferred: avoids an import cycle

        registry.get_encoder(self.encoder)  # raises on unknown encoder
        if self.backend != "auto" and self.backend not in registry.backend_names(
            self.encoder
        ):
            raise ValueError(
                f"unknown backend {self.backend!r} for encoder "
                f"{self.encoder!r}; registered: "
                f"{registry.backend_names(self.encoder)}"
            )

    @property
    def resolved_class_binarize(self) -> str:
        if self.class_binarize != "auto":
            return self.class_binarize
        from repro_torch.core import registry

        return registry.get_encoder(self.encoder).default_class_binarize

    @property
    def resolved_pack_center(self) -> str:
        if self.pack_center != "auto":
            return self.pack_center
        from repro_torch.core import registry

        return registry.get_encoder(self.encoder).default_pack_center


def manifest_config(cfg: HDCConfig) -> dict[str, Any]:
    """The config as a checkpoint manifest stores it: the backend under
    the JAX package's name where its encoder registers one (``"cuda"`` ->
    ``"pallas"``, ``"ref"`` for ``uhd_dynamic``), else ``"auto"``."""
    raw = dataclasses.asdict(cfg)
    name = _TO_MANIFEST.get(cfg.backend, cfg.backend)
    raw["backend"] = name if name in _JAX_BACKENDS.get(cfg.encoder, ()) else "auto"
    return raw


def config_from_manifest(raw: dict[str, Any]) -> HDCConfig:
    """The config of a manifest written by either package.  The stored
    backend reads as ``"auto"``: on a card that is ``"cuda"`` (the JAX
    package's ``"pallas"``), on the CPU ``"ref"``."""
    raw = {k: v for k, v in raw.items() if k not in _LEGACY_FIELDS}
    return HDCConfig(**dict(raw, backend="auto"))


# ---------------------------------------------------------------------------
# Legacy functional API of the JAX package: removed there, absent here
# ---------------------------------------------------------------------------

# name -> the HDCModel replacement, used for the helpful AttributeError.
_REMOVED_FLAT_API = {
    "build_codebooks": "HDCModel.create(cfg).codebooks",
    "encode": "HDCModel.create(cfg).encode(images)",
    "fit": "HDCModel.create(cfg).fit(images, labels)",
    "fit_streaming": "HDCModel.create(cfg).fit_batches(batches)",
    "predict": "HDCModel.predict(images)",
    "evaluate": "HDCModel.evaluate(images, labels)",
}


def __getattr__(name: str) -> Any:
    if name in _REMOVED_FLAT_API:
        raise AttributeError(
            f"repro_torch.core.{name}(cfg, books, ...) was removed after a "
            f"deprecation period; use {_REMOVED_FLAT_API[name]} instead "
            "(see DESIGN.md §2 for the migration table)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def train_and_eval(*args, **kw) -> float:
    """Convenience end-to-end — forwards to repro_torch.core.hdc_model."""
    from repro_torch.core import hdc_model

    return hdc_model.train_and_eval(*args, **kw)


def baseline_iterative_search(*args, **kw) -> list[float]:
    """The paper's baseline protocol — forwards to repro_torch.core.hdc_model."""
    from repro_torch.core import hdc_model

    return hdc_model.baseline_iterative_search(*args, **kw)
