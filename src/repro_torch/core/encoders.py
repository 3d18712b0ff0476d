"""The ``uhd_dynamic`` encoder and its two datapaths.

The paper's headline *dynamic* generation: the codebook is only the
(H, 32) quantized Sobol direction matrix, and thresholds are
regenerated at encode time (see ``repro.core.encoders``, :203-308).

  * ``"cuda"`` — the hand-written kernels of
    :mod:`repro_torch.kernels.ops` (encode, fused training step, packed
    top-k); the port's counterpart of the JAX package's ``"pallas"``.
  * ``"ref"`` — the plain PyTorch versions of
    :mod:`repro_torch.kernels.ref`, for tensors on the CPU.

The table encoder ``uhd`` and the ``baseline`` encoder are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import sobol
from repro_torch.core.registry import (
    EncoderBase,
    register_backend,
    register_encoder,
    register_fit_bundle,
    register_topk,
)

if TYPE_CHECKING:
    from repro_torch.core.model import HDCConfig


def _on_card(platform: str) -> bool:
    return platform == "cuda"


def _off_card(platform: str) -> bool:
    return platform != "cuda"


@register_encoder("uhd_dynamic")
class UHDDynamicEncoder(EncoderBase):
    """uHD encoding with no (H, D) table: the codebook is
    ``{"direction": (H, 32)}`` in the narrowest unsigned dtype holding
    ``levels - 1``, and ``cfg.sobol_skip`` sets the first Sobol point."""

    auto_order = {"cuda": ("cuda",), "default": ("ref",)}
    # uHD hypervectors carry a per-example brightness common mode: class
    # sums stay non-binarized and packing row-centers (DESIGN.md §5-§6).
    default_class_binarize = "none"
    default_pack_center = "row"

    def build_codebooks(self, cfg: "HDCConfig") -> dict[str, torch.Tensor]:
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


@register_fit_bundle("uhd_dynamic", "ref")
def _ref_fit_bundle(cfg, books, x_q, labels):
    """Plain PyTorch fused training step (tile-scan generation)."""
    from repro_torch.kernels import ref as kref

    return kref.fit_bundle_dynamic(
        x_q, books["direction"], labels, cfg.n_classes, cfg.d, skip=cfg.sobol_skip
    )


@register_backend("uhd_dynamic", "cuda", available=_on_card)
def _cuda_encode(cfg, books, x_q):
    """CUDA encode+bundle kernel with in-kernel Sobol generation."""
    from repro_torch.kernels import ops

    return ops.encode_bundle_dynamic(x_q, books["direction"], cfg.d, skip=cfg.sobol_skip)


@register_fit_bundle("uhd_dynamic", "cuda")
def _cuda_fit_bundle(cfg, books, x_q, labels):
    """CUDA fused generate + encode + per-class segment-sum kernel."""
    from repro_torch.kernels import ops

    return ops.fit_bundle_dynamic(
        x_q, books["direction"], labels, cfg.n_classes, cfg.d, skip=cfg.sobol_skip
    )


@register_topk("uhd_dynamic", "cuda")
def _cuda_topk(q_words, c_words, d, k):
    """CUDA split-C packed-Hamming top-k kernel with an exact merge."""
    from repro_torch.kernels import ops

    return ops.hamming_topk(q_words, c_words, d, k)
