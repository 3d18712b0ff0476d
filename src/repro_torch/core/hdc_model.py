"""`HDCModel`: config + codebooks + class-sum state, as an ``nn.Module``.

The torch counterpart of ``repro.core.hdc_model``.  The codebook
(``sobol`` for ``uhd``, ``direction`` for ``uhd_dynamic``) and the raw int32 class-sum
accumulator ``class_sums`` are registered buffers on one explicit
device; ``n_seen`` is a Python int, exact to 2**64, and crosses
checkpoints as the JAX package's (2,) uint32 [hi, lo] split counter.

As in JAX, ``fit`` and ``partial_fit`` return a new model and leave
this one as it was (a server keeps answering from the old model while
the next is trained); ``partial_fit(donate=True)`` and ``fit_batches``
update the accumulator in place.  The models share the read-only
codebook tensors.

Devices: every entry point takes ``device=None``, meaning ``"cuda"``.
Without a card that raises and names ``device="cpu"``; nothing moves to
the CPU by itself.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch
from torch import nn

from repro_torch.core import encoding, metrics, registry, unary
from repro_torch.core.model import HDCConfig, config_from_manifest, manifest_config

_NSEEN_LIMIT = 1 << 64


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch datapath on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, got {dev}")
    return dev


def nseen_array(n: int) -> np.ndarray:
    """A count as the (2,) uint32 [hi, lo] split counter of checkpoints."""
    n = int(n)
    if not 0 <= n < _NSEEN_LIMIT:
        raise ValueError(f"n_seen must be in [0, 2**64), got {n}")
    return np.asarray([n >> 32, n & 0xFFFFFFFF], np.uint32)


def nseen_int(a) -> int:
    """Inverse of :func:`nseen_array`; also takes a legacy () scalar."""
    a = np.asarray(a)
    if a.shape == ():
        return nseen_int(nseen_array(int(a)))
    if a.shape != (2,):
        raise ValueError(f"n_seen must be a scalar or (2,) counter, got {a.shape}")
    hi, lo = (int(v) & 0xFFFFFFFF for v in a.astype(np.int64))
    return (hi << 32) | lo


def _centered(cfg: HDCConfig, hv: torch.Tensor) -> torch.Tensor:
    """Apply the packed-inference centering policy before sign-packing.

    "row" subtracts each row's mean over D.  The row sum is taken in
    int64 and converted to float32; the mean is that sum times the
    float32 reciprocal of D, which is what XLA compiles the JAX
    package's ``x.mean(-1)`` to (a division by D differs from it in the
    last bit).  Equal to the JAX package wherever its float32 sum is
    exact (row sums below 2**24), and independent of the reduction order
    on any device.
    """
    if cfg.resolved_pack_center != "row":
        return hv
    total = hv.to(torch.int64).sum(-1, keepdim=True).to(torch.float32)
    inv_d = np.float32(1.0) / np.float32(hv.shape[-1])
    inv = torch.full((), float(inv_d), dtype=torch.float32, device=hv.device)
    return hv.to(torch.float32) - total * inv


class HDCModel(nn.Module):
    """Config + codebooks + class-HV accumulator on one device."""

    def __init__(
        self,
        cfg: HDCConfig,
        codebooks: dict[str, torch.Tensor],
        class_sums: torch.Tensor | None = None,
        n_seen: int = 0,
        *,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        expected = set(registry.get_encoder(cfg.encoder).codebook_specs(cfg))
        if set(codebooks) != expected:
            raise ValueError(
                f"codebook layout {sorted(codebooks)} does not match encoder "
                f"{cfg.encoder!r} (expects {sorted(expected)})"
            )
        # an explicit backend that does not run on this device fails here,
        # not at the first request
        registry.resolve_backend(cfg.backend, dev.type, encoder=cfg.encoder)
        self.cfg = cfg
        self._codebook_names = tuple(sorted(codebooks))
        for name in self._codebook_names:
            self.register_buffer(name, torch.as_tensor(codebooks[name]).to(dev))
        if class_sums is None:
            class_sums = torch.zeros((cfg.n_classes, cfg.d), dtype=torch.int32)
        if tuple(class_sums.shape) != (cfg.n_classes, cfg.d):
            raise ValueError(
                f"class_sums shape {tuple(class_sums.shape)} != {(cfg.n_classes, cfg.d)}"
            )
        self.register_buffer("class_sums", class_sums.to(dev, torch.int32))
        self.n_seen = nseen_int(nseen_array(n_seen))

    # -- construction ----------------------------------------------------

    @classmethod
    def create(cls, cfg: HDCConfig, *, device: torch.device | str | None = None) -> "HDCModel":
        """Fresh untrained model: codebooks built, accumulator zeroed."""
        return cls(cfg, registry.get_encoder(cfg.encoder).build_codebooks(cfg), device=device)

    def _with_state(self, class_sums: torch.Tensor, n_seen: int) -> "HDCModel":
        return HDCModel(self.cfg, self.codebooks, class_sums, n_seen, device=self.device)

    def to_device(self, device: torch.device | str | None) -> "HDCModel":
        """This model on `device` (itself when it is already there)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return HDCModel(self.cfg, self.codebooks, self.class_sums, self.n_seen, device=dev)

    # -- derived state ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.class_sums.device

    @property
    def codebooks(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._codebook_names}

    @property
    def encoder(self) -> registry.EncoderBase:
        return registry.get_encoder(self.cfg.encoder)

    @property
    def class_hvs(self) -> torch.Tensor:
        """Inference-time class hypervectors per the binarization policy."""
        if self.cfg.resolved_class_binarize == "sign":
            return encoding.binarize(self.class_sums).to(torch.int32)
        return self.class_sums

    @property
    def n_examples(self) -> int:
        return self.n_seen

    def pack(self) -> torch.Tensor:
        """Class HVs centered per `pack_center`, sign-packed to (C, W)
        int32 words: the pack-once serving artifact."""
        return unary.pack_hypervector(_centered(self.cfg, self.class_hvs))

    def pack_queries(self, q: torch.Tensor) -> torch.Tensor:
        """Encoded queries (B, D) -> packed sign bits (B, W), same policy."""
        return unary.pack_hypervector(_centered(self.cfg, q))

    # -- core ops --------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def quantize(self, images) -> torch.Tensor:
        cfg = self.cfg
        return encoding.quantize_images(self._tensor(images), cfg.levels, cfg.max_intensity)

    def encode(self, images) -> torch.Tensor:
        """Raw images (B, H) -> non-binary hypervectors (B, D) int32."""
        return self.encoder.encode(
            self.cfg, self.codebooks, self.quantize(images), backend=self.cfg.backend
        )

    def _fit_sums(self, images, labels) -> tuple[torch.Tensor, int]:
        labels = self._tensor(labels).to(torch.int32)
        encoding.validate_labels(labels, self.cfg.n_classes)
        sums = self.encoder.fit_bundle(
            self.cfg, self.codebooks, self.quantize(images), labels, backend=self.cfg.backend
        )
        return sums, int(labels.shape[0])

    def fit(self, images, labels) -> "HDCModel":
        """Single-pass training on this data alone (a new model)."""
        sums, n = self._fit_sums(images, labels)
        return self._with_state(sums, n)

    def partial_fit(self, images, labels, *, donate: bool = False) -> "HDCModel":
        """Accumulate one batch into the class sums.  Returns a new model;
        with ``donate=True`` this model is updated in place and returned."""
        sums, n = self._fit_sums(images, labels)
        if donate:
            n_seen = nseen_int(nseen_array(self.n_seen + n))  # validate before mutating
            self.class_sums += sums
            self.n_seen = n_seen
            return self
        return self._with_state(self.class_sums + sums, self.n_seen + n)

    def fit_batches(self, batches: Iterable[tuple[Any, Any]]) -> "HDCModel":
        """Memory-bounded fit over (images, labels) batches, equal to `fit`
        on their concatenation; this model's state is left as it was."""
        model = self.reset()
        for images, labels in batches:
            model = model.partial_fit(images, labels, donate=True)
        return model

    def reset(self) -> "HDCModel":
        """Drop accumulated class state (codebooks are kept)."""
        return self._with_state(torch.zeros_like(self.class_sums), 0)

    def convert(self, encoder: str) -> "HDCModel":
        """This model under another encoder of the same family, keeping
        its class sums and ``n_seen`` (a copy) and rebuilding the
        codebooks from the config; the backend becomes ``"auto"``.  The
        use: train with the ``uhd`` table, serve table-free with the
        ~1000x smaller ``uhd_dynamic`` codebook.  Conversion across
        families raises ``ValueError``: their class sums do not carry
        over."""
        cur, new = self.encoder, registry.get_encoder(encoder)
        if (cur.family or cur.name) != (new.family or new.name):
            raise ValueError(
                f"cannot convert encoder {cur.name!r} (family {cur.family or cur.name!r}) "
                f"to {new.name!r} (family {new.family or new.name!r}): class sums only "
                "transfer between encoders with bit-identical encode semantics"
            )
        cfg = dataclasses.replace(self.cfg, encoder=encoder, backend="auto")
        return HDCModel(
            cfg, new.build_codebooks(cfg), self.class_sums.clone(), self.n_seen,
            device=self.device,
        )

    def predict(self, images) -> torch.Tensor:
        """Encode queries, score against the class HVs, argmax -> (B,) int32."""
        cfg = self.cfg
        q = self.encode(images)
        if cfg.binarize_query:
            q = encoding.binarize(q).to(torch.int32)
        if cfg.similarity == "hamming":
            sim = metrics.hamming_similarity_packed(
                self.pack_queries(q), self.pack(), cfg.d
            ).to(torch.float32)
        else:
            sim = metrics.SIMILARITIES[cfg.similarity](q, self.class_hvs)
        return metrics.classify(sim)

    def evaluate(self, images, labels, batch_size: int = 1024) -> float:
        """Test accuracy, evaluated in batches."""
        n = len(images)
        correct = 0
        for i in range(0, n, batch_size):
            pred = self.predict(images[i : i + batch_size])
            correct += int((pred == self._tensor(labels[i : i + batch_size])).sum())
        return correct / n

    # -- persistence -----------------------------------------------------

    def save(self, path: str | Path, *, step: int = 0, keep_n: int = 3) -> None:
        """Atomic checkpoint of one step under `path`, in the JAX package's
        layout and leaf keys; the config rides in the manifest."""
        from repro_torch.checkpoint.manager import CheckpointManager

        state = {
            "codebooks": self.codebooks,
            "class_sums": self.class_sums,
            "n_seen": nseen_array(self.n_seen),
        }
        CheckpointManager(path, keep_n=keep_n).save(
            step, state, extra={"hdc_config": manifest_config(self.cfg)}
        )

    @classmethod
    def load(
        cls, path: str | Path, *, step: int | None = None,
        device: torch.device | str | None = None,
    ) -> "HDCModel":
        """Restore a checkpoint written by either package (latest step by
        default) onto `device`.  The stored backend name is not kept: the
        datapath follows `device` (see :func:`config_from_manifest`)."""
        from repro_torch.checkpoint.manager import CheckpointManager

        mgr = CheckpointManager(path)
        if step is None:
            step = mgr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
        raw = mgr.extra(step).get("hdc_config")
        if raw is None:
            raise ValueError(f"checkpoint step {step} has no hdc_config manifest")
        cfg = config_from_manifest(raw)
        specs = registry.get_encoder(cfg.encoder).codebook_specs(cfg)
        nseen_shape = tuple(mgr.leaf_meta(step).get("n_seen", {}).get("shape", (2,)))
        like = {
            "codebooks": {k: shape for k, (shape, _) in specs.items()},
            "class_sums": (cfg.n_classes, cfg.d),
            "n_seen": nseen_shape,
        }
        state = mgr.restore(step, like)
        books = {
            k: torch.from_numpy(np.ascontiguousarray(state["codebooks"][k], dtype=dt))
            for k, (_, dt) in specs.items()
        }
        sums = torch.from_numpy(np.ascontiguousarray(state["class_sums"], dtype=np.int32))
        return cls(cfg, books, sums, nseen_int(state["n_seen"]), device=device)


# ---------------------------------------------------------------------------
# Packed serving path (the JAX package's predict_packed / search_packed)
# ---------------------------------------------------------------------------


def search_packed(
    model: HDCModel, images, item_words: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode queries, scan a packed (C, W) store, return the k nearest
    rows per query: ((B, k) int32 indices, (B, k) int32 Hamming
    distances), ascending by (distance, index).  The model's backend
    picks the scan: the kernel on a card, the tiled plain version on
    the CPU; both equal ``kernels.ref.hamming_topk_oracle``."""
    cfg = model.cfg
    q = model.encode(images)
    if cfg.binarize_query:
        q = encoding.binarize(q).to(torch.int32)
    return model.encoder.topk(
        model.pack_queries(q), item_words, cfg.d, k, backend=cfg.backend
    )


def predict_packed(model: HDCModel, images, class_words: torch.Tensor) -> torch.Tensor:
    """Serving fast path: the k=1 case of :func:`search_packed`; labels
    equal ``predict`` with ``similarity="hamming"``."""
    indices, _ = search_packed(model, images, class_words, k=1)
    return indices[:, 0]
