"""The encoders, ``uhd`` (stored table), ``uhd_dynamic`` (table-free)
and ``baseline`` (the paper's Fig. 1), and their two datapaths each.

Both encode a pixel h against the quantized Sobol thresholds S[h, :]
(see ``repro.core.encoders``, :93-308): ``uhd`` stores the (H, D)
threshold table, ``uhd_dynamic`` only the (H, 32) quantized direction
matrix and regenerates thresholds at encode time.  From the same config
they give bit-identical hypervectors, so they are one family and
``HDCModel.convert`` moves class sums between them.

  * ``"cuda"`` — the hand-written kernels of
    :mod:`repro_torch.kernels.ops` (encode, fused training step, packed
    top-k); the port's counterpart of the JAX package's ``"pallas"``.
  * ``"ref"`` — the plain PyTorch versions of
    :mod:`repro_torch.kernels.ref`, for tensors on the CPU.

``baseline`` binds pseudo-random position hypervectors P (H, D) with
level hypervectors L (levels + 1, D), both ±1 int8 and drawn as the JAX
package draws them (:mod:`repro_torch.core.prng`).  Its ``"cuda"``
datapath encodes through the int8 tensor-core kernel
``ops.encode_unary_mxu_operands`` and trains by encode, then the
bundling kernel (it registers no fused step, as in JAX).

The device is the only datapath switch: the JAX package's other
datapaths (``naive``, ``blocked``, ``unary_matmul``, ``unary_oracle``)
are plain functions in :mod:`repro_torch.core.encoding`, not registered
backends, and a manifest that names one loads as ``"auto"``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import prng, sobol
from repro_torch.core.registry import (
    EncoderBase,
    register_backend,
    register_encoder,
    register_encode_slice,
    register_fit_bundle,
    register_topk,
)
from repro_torch.obs.profiler import span

if TYPE_CHECKING:
    from repro_torch.core.model import HDCConfig


def _on_card(platform: str) -> bool:
    return platform == "cuda"


def _off_card(platform: str) -> bool:
    return platform != "cuda"


@register_encoder("uhd")
class UHDEncoder(EncoderBase):
    """uHD encoding over a stored threshold table: the codebook is
    ``{"sobol": (H, D)}``, the quantized Sobol points ``sobol_skip ..
    sobol_skip + D - 1`` of each feature's dimension, int8 when
    ``levels <= 127`` and int32 otherwise."""

    auto_order = {"cuda": ("cuda",), "default": ("ref",)}
    family = "uhd"
    # uHD hypervectors carry a per-example brightness common mode: class
    # sums stay non-binarized and packing row-centers (DESIGN.md §5-§6).
    default_class_binarize = "none"
    default_pack_center = "row"

    @staticmethod
    def _sobol_dtype(cfg: "HDCConfig") -> np.dtype:
        return np.dtype(np.int8 if cfg.levels <= 127 else np.int32)

    def build_codebooks(self, cfg: "HDCConfig") -> dict[str, torch.Tensor]:
        """The table, in the span ``sobol.directions`` (its direction
        numbers and the Gray-code fill)."""
        with span("sobol.directions"):
            table = sobol.sobol_table_for_features(
                cfg.n_features, cfg.d, cfg.levels, seed=cfg.seed, skip=cfg.sobol_skip
            )
        return {"sobol": torch.from_numpy(table.astype(self._sobol_dtype(cfg)))}

    def codebook_specs(self, cfg: "HDCConfig") -> dict[str, tuple[tuple[int, ...], np.dtype]]:
        return {"sobol": ((cfg.n_features, cfg.d), self._sobol_dtype(cfg))}


@register_backend("uhd", "ref", available=_off_card)
def _uhd_ref_encode(cfg, books, x_q):
    """Plain PyTorch D-tiled compare over the table (CPU tensors)."""
    from repro_torch.kernels import ref as kref

    return kref.encode_bundle(x_q, books["sobol"])


# `d` and `point_offset` are ignored by the table forms: a D-shard's table
# arrives pre-sliced in `books["sobol"]`, which fixes both its width and
# its offset; only the generator encoder consumes them.


@register_fit_bundle("uhd", "ref")
def _uhd_ref_fit_bundle(cfg, books, x_q, labels, *, d, point_offset):
    """Plain PyTorch D-tile scan with a per-class segment sum."""
    from repro_torch.kernels import ref as kref

    return kref.fit_bundle(x_q, books["sobol"], labels, cfg.n_classes)


@register_backend("uhd", "cuda", available=_on_card)
def _uhd_cuda_encode(cfg, books, x_q):
    """CUDA encode+bundle kernel over the stored table."""
    from repro_torch.kernels import ops

    return ops.encode_bundle(x_q, books["sobol"])


@register_fit_bundle("uhd", "cuda")
def _uhd_cuda_fit_bundle(cfg, books, x_q, labels, *, d, point_offset):
    """CUDA fused encode + per-class segment-sum kernel over the table."""
    from repro_torch.kernels import ops

    return ops.fit_bundle(x_q, books["sobol"], labels, cfg.n_classes)


@register_topk("uhd", "cuda")
def _uhd_cuda_topk(q_words, c_words, d, k):
    """CUDA split-C packed-Hamming top-k kernel with an exact merge."""
    from repro_torch.kernels import ops

    return ops.hamming_topk(q_words, c_words, d, k)


@register_encoder("uhd_dynamic")
class UHDDynamicEncoder(UHDEncoder):
    """uHD encoding with no (H, D) table: the codebook is
    ``{"direction": (H, 32)}`` in the narrowest unsigned dtype holding
    ``levels - 1``, and ``cfg.sobol_skip`` sets the first Sobol point.
    The family and its policies are ``uhd``'s.  A D-shard generates only
    the points of its slice, ``sobol_skip + point_offset`` onwards, with
    the (H, 32) matrix replicated."""

    dynamic_generator = True

    def build_codebooks(self, cfg: "HDCConfig") -> dict[str, torch.Tensor]:
        """The quantized direction numbers, in the span ``sobol.directions``."""
        with span("sobol.directions"):
            dirs = sobol.quantized_direction_matrix(cfg.n_features, cfg.levels, seed=cfg.seed)
        return {"direction": torch.from_numpy(np.ascontiguousarray(dirs))}

    def codebook_specs(self, cfg: "HDCConfig") -> dict[str, tuple[tuple[int, ...], np.dtype]]:
        return {
            "direction": (
                (cfg.n_features, sobol.N_BITS),
                sobol.quantized_direction_dtype(cfg.levels),
            )
        }


@register_backend("uhd_dynamic", "ref", available=_off_card)
def _ref_encode(cfg, books, x_q):
    """Plain PyTorch per-D-tile Sobol regeneration (CPU tensors)."""
    from repro_torch.core import encoding

    return encoding.uhd_encode_dynamic(x_q, books["direction"], cfg.d, skip=cfg.sobol_skip)


def _skip(cfg, point_offset) -> int:
    """First Sobol point of a (shard's) slice."""
    return cfg.sobol_skip if point_offset is None else cfg.sobol_skip + point_offset


@register_fit_bundle("uhd_dynamic", "ref")
def _ref_fit_bundle(cfg, books, x_q, labels, *, d, point_offset):
    """Plain PyTorch fused training step (tile-scan generation)."""
    from repro_torch.kernels import ref as kref

    return kref.fit_bundle_dynamic(
        x_q, books["direction"], labels, cfg.n_classes, d, skip=_skip(cfg, point_offset)
    )


@register_encode_slice("uhd_dynamic", "ref")
def _ref_encode_slice(cfg, books, x_q, *, d, point_offset):
    """Plain PyTorch D-slice generation: points ``[skip + offset,
    skip + offset + d)`` only."""
    from repro_torch.core import encoding

    return encoding.uhd_encode_dynamic(x_q, books["direction"], d, skip=_skip(cfg, point_offset))


@register_backend("uhd_dynamic", "cuda", available=_on_card)
def _cuda_encode(cfg, books, x_q):
    """CUDA encode+bundle kernel with in-kernel Sobol generation."""
    from repro_torch.kernels import ops

    return ops.encode_bundle_dynamic(x_q, books["direction"], cfg.d, skip=cfg.sobol_skip)


@register_fit_bundle("uhd_dynamic", "cuda")
def _cuda_fit_bundle(cfg, books, x_q, labels, *, d, point_offset):
    """CUDA fused generate + encode + per-class segment-sum kernel."""
    from repro_torch.kernels import ops

    return ops.fit_bundle_dynamic(
        x_q, books["direction"], labels, cfg.n_classes, d, skip=_skip(cfg, point_offset)
    )


@register_encode_slice("uhd_dynamic", "cuda")
def _cuda_encode_slice(cfg, books, x_q, *, d, point_offset):
    """CUDA encode kernel re-aimed at a D-slice: its ``skip`` is a run-time
    argument, so a shard's slice goes through the kernel too."""
    from repro_torch.kernels import ops

    return ops.encode_bundle_dynamic(x_q, books["direction"], d, skip=_skip(cfg, point_offset))


@register_topk("uhd_dynamic", "cuda")
def _cuda_topk(q_words, c_words, d, k):
    """CUDA split-C packed-Hamming top-k kernel with an exact merge."""
    from repro_torch.kernels import ops

    return ops.hamming_topk(q_words, c_words, d, k)


@register_encoder("baseline")
class BaselineEncoder(EncoderBase):
    """Comparator-generated pseudo-random position/level codebooks
    ``{"p": (H, D), "level": (levels + 1, D)}``, ±1 int8, drawn from
    ``jax.random.PRNGKey(cfg.seed)`` as the JAX package draws them: the
    paper's iteration index i is ``seed=i``.  The class policies are
    ``EncoderBase``'s (sign-binarized class sums, no centering)."""

    auto_order = {"cuda": ("cuda",), "default": ("ref",)}
    family = "baseline"

    def build_codebooks(self, cfg: "HDCConfig") -> dict[str, torch.Tensor]:
        from repro_torch.core import encoding

        p, level = encoding.make_baseline_codebooks(
            prng.prng_key(cfg.seed), cfg.n_features, cfg.d, cfg.levels
        )
        return {"p": p, "level": level}

    def codebook_specs(self, cfg: "HDCConfig") -> dict[str, tuple[tuple[int, ...], np.dtype]]:
        return {
            "p": ((cfg.n_features, cfg.d), np.dtype(np.int8)),
            "level": ((cfg.levels + 1, cfg.d), np.dtype(np.int8)),
        }


@register_backend("baseline", "ref", available=_off_card)
def _baseline_ref_encode(cfg, books, x_q):
    """Plain PyTorch one-hot contraction (CPU tensors)."""
    from repro_torch.core import encoding

    return encoding.baseline_encode(x_q, books["p"], books["level"])


@register_backend("baseline", "cuda", available=_on_card)
def _baseline_cuda_encode(cfg, books, x_q):
    """The one-hot x [P == L] product on the int8 tensor-core kernel
    (kernel 7): the one-hot of x built per call, [P == L] once per
    codebook set (``encoding.BASELINE_OPERANDS``)."""
    from repro_torch.core import encoding
    from repro_torch.kernels import ops

    return ops.encode_unary_mxu_operands(*encoding.baseline_operands(x_q, books["p"], books["level"]))


@register_topk("baseline", "cuda")
def _baseline_cuda_topk(q_words, c_words, d, k):
    """CUDA split-C packed-Hamming top-k kernel with an exact merge."""
    from repro_torch.kernels import ops

    return ops.hamming_topk(q_words, c_words, d, k)
