"""Encoder/backend registries: the single dispatch point of the port.

The torch counterpart of ``repro.core.registry``.  An encoder registers
its codebook layout and a table of datapaths ("backends"); a backend
may attach a fused training step (``register_fit_bundle``), a D-slice
encode for sharded serving (``register_encode_slice``) and a packed
top-k search (``register_topk``).  :func:`resolve_backend` maps a
requested name, or ``"auto"``, plus the platform of the model's tensors
(``"cuda"`` or ``"cpu"``) to a concrete backend; :func:`resolve_impl`
names the packed top-k path that a platform runs.

Availability follows the device alone: the ``"cuda"`` backend runs the
hand-written kernels and is available exactly when the tensors are on a
card; the plain ``"ref"`` backend is for CPU tensors.  An explicit name
that does not fit the device raises :class:`BackendUnavailableError`
(a ``ValueError``); nothing demotes one backend to another, and a build
or launch failure of a kernel propagates.  A backend without a fused
training step trains by encode, then ``encoding.bundle_by_class`` (the
bundling kernel on a card); one without a top-k datapath searches
through ``ops.hamming_topk``, which also chooses by device.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Protocol, runtime_checkable

import torch

if TYPE_CHECKING:
    from repro_torch.core.model import HDCConfig

#: (cfg, codebooks, x_q) -> (B, D) int32 hypervectors
BackendFn = Callable[..., torch.Tensor]
#: (cfg, codebooks, x_q, labels, *, d, point_offset) -> (C, d) int32 class sums
FitBundleFn = Callable[..., torch.Tensor]
#: (cfg, codebooks, x_q, *, d, point_offset) -> (B, d) int32 hypervector columns
EncodeSliceFn = Callable[..., torch.Tensor]
#: (q_words, c_words, d, k) -> ((B, k) int32 indices, (B, k) int32 distances)
TopkFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]
AvailabilityProbe = Callable[[str], bool]  # platform -> usable?


@runtime_checkable
class Encoder(Protocol):
    """What a registered encoder must provide (the public protocol)."""

    name: str

    def build_codebooks(self, cfg: "HDCConfig") -> dict[str, torch.Tensor]: ...

    def encode(
        self, cfg: "HDCConfig", codebooks: dict[str, torch.Tensor], x_q: torch.Tensor,
        *, backend: str = "auto",
    ) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One registered datapath of one encoder."""

    encoder: str
    name: str
    fn: BackendFn
    available: AvailabilityProbe
    fit_bundle: FitBundleFn | None = None
    encode_slice: EncodeSliceFn | None = None
    topk: TopkFn | None = None


_ENCODERS: dict[str, "EncoderBase"] = {}
_BACKENDS: dict[str, dict[str, BackendSpec]] = {}


class BackendUnavailableError(ValueError):
    """An explicitly requested backend cannot run on this device."""


def platform_of(device: torch.device | str) -> str:
    """The registry's platform key of a device: "cuda" or "cpu"."""
    return torch.device(device).type


class EncoderBase:
    """Base class for registered encoders (see ``repro.core.registry``)."""

    name: str = ""
    #: Encoders that encode bit-identically from the same config share
    #: a family name; ``HDCModel.convert`` moves class state only within
    #: a family.  Empty means "own name only".
    family: str = ""
    #: platform -> preference order; "default" is the fallback entry.
    auto_order: dict[str, tuple[str, ...]] = {"default": ("ref",)}
    default_class_binarize: str = "sign"
    default_pack_center: str = "none"
    #: True when the codebook generates the D thresholds instead of
    #: storing them: a D-shard then hands its backend ``point_offset``,
    #: the start of its slice in the generated stream; a table encoder's
    #: shard gets its codebook pre-sliced instead.
    dynamic_generator: bool = False

    def build_codebooks(self, cfg: "HDCConfig") -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def codebook_specs(self, cfg: "HDCConfig") -> dict[str, tuple[tuple[int, ...], object]]:
        """Codebook leaf -> (shape, numpy dtype), without building it."""
        raise NotImplementedError

    def _spec(self, backend: str, platform: str) -> BackendSpec:
        return _BACKENDS[self.name][resolve_backend(backend, platform, encoder=self.name)]

    def encode(self, cfg, codebooks, x_q, *, backend: str = "auto") -> torch.Tensor:
        """Quantized features (B, H) -> non-binary hypervectors (B, D)."""
        return self._spec(backend, platform_of(x_q.device)).fn(cfg, codebooks, x_q)

    def fit_bundle(
        self, cfg, codebooks, x_q, labels, *, backend: str = "auto", d: int | None = None,
        point_offset: int | None = None,
    ) -> torch.Tensor:
        """Quantized features + labels -> (C, d) int32 class sums through
        the backend's fused training step, or, where it registers none,
        its encode followed by ``encoding.bundle_by_class``; both give the
        same sums.  ``d`` (default ``cfg.d``) is the local width and
        ``point_offset`` a generator shard's start in the Sobol stream:
        the D-sharding hooks (a table shard's codebook is pre-sliced).  A
        ``point_offset`` needs a fused step: the fallback cannot re-aim a
        generated encode at a D-slice."""
        spec = self._spec(backend, platform_of(x_q.device))
        if spec.fit_bundle is not None:
            return spec.fit_bundle(
                cfg, codebooks, x_q, labels, d=cfg.d if d is None else d,
                point_offset=point_offset,
            )
        if point_offset is not None:
            raise BackendUnavailableError(
                f"backend {spec.name!r} of encoder {self.name!r} registers no fused "
                "fit_bundle datapath; sharded generator D-slices (point_offset) need one"
            )
        from repro_torch.core import encoding  # deferred: avoids an import cycle

        return encoding.bundle_by_class(spec.fn(cfg, codebooks, x_q), labels, cfg.n_classes)

    def encode_slice(
        self, cfg, codebooks, x_q, *, backend: str = "auto", d: int | None = None,
        point_offset: int | None = None,
    ) -> torch.Tensor:
        """Quantized features (B, H) -> hypervector D-slice (B, d), equal
        to columns ``[point_offset, point_offset + d)`` of the full encode.
        A table shard's codebook is pre-sliced, so its plain encode gives
        the slice; a generator shard (``point_offset`` given) needs the
        backend's registered ``encode_slice``."""
        spec = self._spec(backend, platform_of(x_q.device))
        if spec.encode_slice is not None:
            return spec.encode_slice(
                cfg, codebooks, x_q, d=cfg.d if d is None else d, point_offset=point_offset
            )
        if point_offset is not None:
            raise BackendUnavailableError(
                f"backend {spec.name!r} of encoder {self.name!r} registers no "
                "encode_slice datapath; sharded generator D-slices (point_offset) need one"
            )
        return spec.fn(cfg, codebooks, x_q)

    def topk(self, q_words, c_words, d: int, k: int, *, backend: str = "auto"):
        """Packed top-k retrieval, the single dispatch point of the
        serving path; a backend without a top-k datapath runs
        ``ops.hamming_topk``, which chooses by device (the kernel on a
        card, the plain version on the CPU)."""
        spec = self._spec(backend, platform_of(q_words.device))
        if spec.topk is not None:
            return spec.topk(q_words, c_words, d, k)
        from repro_torch.kernels import ops

        return ops.hamming_topk(q_words, c_words, d, k)


def register_encoder(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register an EncoderBase subclass."""

    def deco(cls: type) -> type:
        inst = cls()
        inst.name = name
        _ENCODERS[name] = inst
        _BACKENDS.setdefault(name, {})
        return cls

    return deco


def register_backend(
    encoder: str, name: str, *, available: AvailabilityProbe | None = None
) -> Callable[[BackendFn], BackendFn]:
    """Function decorator: register one datapath for one encoder."""

    def deco(fn: BackendFn) -> BackendFn:
        _BACKENDS.setdefault(encoder, {})[name] = BackendSpec(
            encoder=encoder, name=name, fn=fn,
            available=available or (lambda platform: True),
        )
        return fn

    return deco


def _attach(kind: str, encoder: str, backend: str):
    def deco(fn):
        table = _BACKENDS.get(encoder, {})
        if backend not in table:
            raise ValueError(
                f"register_{kind}({encoder!r}, {backend!r}): backend is not "
                f"registered (have {sorted(table)}); register the encode datapath first"
            )
        _BACKENDS[encoder][backend] = dataclasses.replace(table[backend], **{kind: fn})
        return fn

    return deco


def register_fit_bundle(encoder: str, backend: str) -> Callable[[FitBundleFn], FitBundleFn]:
    """Function decorator: attach a fused training step to a backend."""
    return _attach("fit_bundle", encoder, backend)


def register_encode_slice(
    encoder: str, backend: str
) -> Callable[[EncodeSliceFn], EncodeSliceFn]:
    """Function decorator: attach a D-slice encode to a backend."""
    return _attach("encode_slice", encoder, backend)


def register_topk(encoder: str, backend: str) -> Callable[[TopkFn], TopkFn]:
    """Function decorator: attach a packed top-k datapath to a backend."""
    return _attach("topk", encoder, backend)


def _ensure_builtin() -> None:
    if not _ENCODERS:
        from repro_torch.core import encoders  # noqa: F401  (registers on import)


def get_encoder(name: str) -> EncoderBase:
    _ensure_builtin()
    try:
        return _ENCODERS[name]
    except KeyError:
        raise ValueError(
            f"unknown encoder {name!r}; registered: {sorted(_ENCODERS)}"
        ) from None


def encoder_names() -> tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_ENCODERS))


def backend_names(encoder: str) -> tuple[str, ...]:
    _ensure_builtin()
    if encoder not in _BACKENDS:
        raise ValueError(f"unknown encoder {encoder!r}; registered: {sorted(_ENCODERS)}")
    return tuple(sorted(_BACKENDS[encoder]))


def resolve_backend(name: str | None, platform: str, *, encoder: str) -> str:
    """Map a requested backend name to a registered backend usable on
    ``platform`` ("cuda" or "cpu").  ``None``/``"auto"`` walks the
    encoder's preference order; an explicit name is honoured exactly or
    raises."""
    _ensure_builtin()
    enc = get_encoder(encoder)
    table = _BACKENDS[encoder]
    if name is None or name == "auto":
        order = enc.auto_order.get(platform, enc.auto_order["default"])
        for cand in order:
            spec = table.get(cand)
            if spec is not None and spec.available(platform):
                return cand
        raise BackendUnavailableError(
            f"no usable backend for encoder {encoder!r} on {platform!r} (tried {order})"
        )
    if name not in table:
        raise ValueError(
            f"unknown backend {name!r} for encoder {encoder!r}; registered: {sorted(table)}"
        )
    if not table[name].available(platform):
        raise BackendUnavailableError(
            f"backend {name!r} (encoder {encoder!r}) does not run on {platform!r} "
            "tensors: 'cuda' runs the kernels on a card, 'ref' the plain versions "
            "on the CPU"
        )
    return name


def backend_table() -> dict[str, dict[str, BackendSpec]]:
    """Read-only snapshot of the full registry (for docs/benchmarks):
    encoder -> backend name -> spec.  The port's backends are ``"ref"``
    (the plain PyTorch datapath, for CPU tensors) and ``"cuda"`` (the
    hand-written kernels, for tensors on a card), not the JAX package's
    names (``"naive"``, ``"pallas"``, ...)."""
    _ensure_builtin()
    return {e: dict(t) for e, t in _BACKENDS.items()}


_IMPLS = ("cuda", "ref")
_PLATFORMS = ("cuda", "cpu")


def resolve_impl(impl: str = "auto", platform: str | None = None) -> str:
    """Packed top-k implementation for a platform ("cuda" or "cpu").

    "auto" is "cuda" (the kernel) on a card and "ref" (the plain
    version) on the CPU; an explicit name must fit the platform.
    ``platform=None`` means the default device, "cuda".  The port's
    counterpart of ``repro.serving.execution.resolve_impl``.
    """
    platform = platform or "cuda"
    if platform not in _PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; valid: {', '.join(_PLATFORMS)}")
    if impl == "auto":
        return "cuda" if platform == "cuda" else "ref"
    if impl not in _IMPLS:
        raise ValueError(
            f"unknown packed top-k impl {impl!r}; valid: auto, {', '.join(_IMPLS)}"
        )
    if (impl == "cuda") != (platform == "cuda"):
        raise ValueError(
            f"impl {impl!r} does not run on {platform!r} tensors: 'cuda' runs the "
            "kernel on a card, 'ref' the plain version on the CPU"
        )
    return impl
