"""Quantization, uHD encoding (table and table-free), bundling and binarization.

The torch counterpart of the parts of ``repro.core.encoding`` that the
``uhd`` and ``uhd_dynamic`` paths run.  A pixel h with quantized intensity x_h and
Sobol thresholds S[h, :] contributes the level hypervector
``L_h[d] = +1 if x_h >= S[h, d] else -1``; an image hypervector is
``sum_h L_h`` (no position hypervectors, no binding).  Every function
here is integer-exact and equals its JAX counterpart bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_images(
    images: torch.Tensor, levels: int, max_val: float = 255.0
) -> torch.Tensor:
    """Quantize intensities in [0, max_val] to int32 levels in [0, levels].

    float32 ``floor(clip(x * r, 0, 1) * levels)`` with ``r =
    float32(1) / float32(max_val)``: the form XLA compiles the JAX
    package's ``x / max_val`` to under ``jax.jit``.  The JAX package is
    not consistent with itself here: its eager ``quantize_images`` and
    ``HDCModel.encode`` divide, while its jitted ``fit``,
    ``partial_fit``, ``predict``, ``predict_packed`` and
    ``search_packed`` multiply, and the two differ on a few non-integer
    intensities in a million (never on an integer one).  The port
    follows the jitted paths, since class sums and served labels come
    from them.  ``r`` is a float32 tensor on the images' device, so the
    CPU and the card run the same multiply (a Python-number divisor
    would leave the choice to each device's division).
    """
    x = images.to(torch.float32)
    inv = torch.full((), float(np.float32(1.0) / np.float32(max_val)), dtype=torch.float32,
                     device=x.device)
    x = torch.clamp(x * inv, 0.0, 1.0)
    return torch.floor(x * levels).to(torch.int32)


def uhd_encode(x_q: torch.Tensor, sobol_q: torch.Tensor) -> torch.Tensor:
    """Position-free Sobol encode+bundle over a stored table, by one
    broadcast compare: (B, H) int, (H, D) int -> (B, D) int32,
    ``hv[b, d] = 2 * #{h : x[b, h] >= S[h, d]} - H``.  The (B, H, D)
    transient makes it a test oracle for small shapes only."""
    h = x_q.shape[-1]
    ge = x_q.to(torch.int32)[:, :, None] >= sobol_q.to(torch.int32)[None, :, :]
    return 2 * ge.sum(dim=1, dtype=torch.int32) - h


def uhd_encode_dynamic(
    x_q: torch.Tensor, direction: torch.Tensor, d: int, *, skip: int = 1
) -> torch.Tensor:
    """Table-free uHD encode+bundle, (B, H) -> (B, d) int32 (plain torch).

    Thresholds are regenerated per D-tile from the (H, 32) quantized
    direction matrix by Gray-code XOR, starting at Sobol point ``skip``.
    """
    from repro_torch.kernels import ref as kref

    return kref.encode_bundle_dynamic(x_q, direction, d, skip=skip)


def bundle_by_class(hvs: torch.Tensor, labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Per-class int32 segment sum, (B, D), (B,) -> (C, D).

    A label outside ``[0, n_classes)`` is dropped from the sums, as in
    the JAX package; the host-facing entry points reject such labels
    first with :func:`validate_labels`.
    """
    labels = labels.to(torch.int64)
    keep = (labels >= 0) & (labels < n_classes)
    out = torch.zeros((n_classes, hvs.shape[-1]), dtype=torch.int32, device=hvs.device)
    return out.index_add_(0, labels[keep], hvs[keep].to(torch.int32))


def validate_labels(labels, n_classes: int) -> None:
    """Raise on labels outside ``[0, n_classes)`` instead of dropping them."""
    arr = labels.cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
    if arr.size == 0:
        return
    bad = arr[(arr < 0) | (arr >= n_classes)]
    if bad.size:
        raise ValueError(
            f"labels must be in [0, {n_classes}); got out-of-range values "
            f"{np.unique(bad)[:8].tolist()} — the bundling kernels drop such "
            "labels from class_sums while n_seen still counts them, so they "
            "are rejected at the API boundary"
        )


def binarize(hv: torch.Tensor) -> torch.Tensor:
    """Sign binarization; ties (sum == 0) resolve to +1."""
    one = torch.ones((), dtype=torch.int8, device=hv.device)
    return torch.where(hv >= 0, one, -one)
