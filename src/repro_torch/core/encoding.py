"""Quantization, the uHD and baseline encoders, bundling and binarization.

The torch counterpart of ``repro.core.encoding``.  uHD: a pixel h with
quantized intensity x_h and Sobol thresholds S[h, :] contributes the
level hypervector ``L_h[d] = +1 if x_h >= S[h, d] else -1``; an image
hypervector is ``sum_h L_h`` (no position hypervectors, no binding).
The baseline (paper Fig. 1) binds pseudo-random position hypervectors
P[h] with level hypervectors L[x_h] and bundles: ``sum_h P[h] * L[x_h]``.
Every function here is integer-exact and equals its JAX counterpart
bit for bit; the several uHD datapaths of the JAX package
(``blocked``, ``unary_matmul``, ``unary_oracle``) come over as plain
functions for the tests, since the port's device is its only datapath
switch.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import numpy as np
import torch

from repro_torch.core import prng, unary


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


def uhd_encode_blocked(x_q: torch.Tensor, sobol_q: torch.Tensor, block_d: int = 2048) -> torch.Tensor:
    """:func:`uhd_encode` with D blocked, so the compare transient is
    (B, H, block_d)."""
    from repro_torch.kernels import ref as kref

    return kref.encode_bundle(x_q, sobol_q, block_d=block_d)


def uhd_encode_unary_matmul(x_q: torch.Tensor, sobol_q: torch.Tensor, levels: int) -> torch.Tensor:
    """The binary-matmul form of the uHD encode: the inclusive
    thermometer of x, (B, H * levels), times the one-hot of the
    thresholds, (H * levels, D), counts ``#{h : x >= S}`` exactly; the
    plain version of kernel 7 on those operands."""
    from repro_torch.kernels import ref as kref

    return kref.encode_unary_mxu(*kref.unary_mxu_operands(x_q, sobol_q, levels))


def uhd_encode_via_unary_comparator(
    x_q: torch.Tensor, sobol_q: torch.Tensor, levels: int
) -> torch.Tensor:
    """Bit-exact functional simulation of the uHD datapath (Figs. 3-4):
    fetch from the unary stream table, unary comparator, ±1, bundle.
    Slow; a cross-oracle for the tests."""
    ust = unary.unary_stream_table(levels, device=x_q.device)
    xs = unary.fetch_unary(x_q, ust)  # (B, H, W)
    ss = unary.fetch_unary(sobol_q, ust)  # (H, D, W)
    ge = unary.unary_ge(xs[:, :, None, :], ss[None, :, :, :], levels)  # (B, H, D)
    return 2 * ge.sum(dim=1, dtype=torch.int32) - x_q.shape[-1]


def uhd_encode_dynamic(
    x_q: torch.Tensor, direction: torch.Tensor, d: int, *, skip: int = 1
) -> torch.Tensor:
    """Table-free uHD encode+bundle, (B, H) -> (B, d) int32 (plain torch).

    Thresholds are regenerated per D-tile from the (H, 32) quantized
    direction matrix by Gray-code XOR, starting at Sobol point ``skip``.
    """
    from repro_torch.kernels import ref as kref

    return kref.encode_bundle_dynamic(x_q, direction, d, skip=skip)


def make_baseline_codebooks(
    key: np.ndarray, n_features: int, d: int, levels: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pseudo-random position and level hypervectors (paper Fig. 1(a)),
    the JAX package's draw from the same ``jax.random`` key (a
    :func:`repro_torch.core.prng.prng_key`), bit for bit.

    P: (H, D) ±1 int8, iid (a uniform compared with 0.5).
    L: (levels + 1, D) ±1 int8: level k is -1 where R > k for R ~
    U[0, levels + 1), so neighbouring levels are correlated.
    """
    kp, kl = prng.split(key)
    p = np.where(prng.uniform(kp, (n_features, d)) > np.float32(0.5), -1, 1).astype(np.int8)
    r = prng.uniform(kl, (d,), 0.0, float(levels + 1))
    ks = np.arange(levels + 1, dtype=np.float32)[:, None]
    level = np.where(r[None, :] > ks, -1, 1).astype(np.int8)
    return torch.from_numpy(p), torch.from_numpy(level)


def baseline_encode_naive(x_q: torch.Tensor, p: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Gather-based baseline: ``hv[b] = sum_h P[h] * L[x[b, h]]``, the
    direct transcription of Fig. 1 ((B, H, D) transient; tests only)."""
    bound = p[None, :, :].to(torch.int32) * level[x_q.to(torch.int64)].to(torch.int32)
    return bound.sum(dim=1, dtype=torch.int32)


class BaselineOperandCache:
    """Kernel 7's per-model operand of the baseline, O = [P == L], (D, Kp)
    int8 (109 MB at D = 8192), built once per codebook set and device.

    O depends on the codebooks alone, and the same ``p``/``level``
    tensors pass unchanged through ``fit``, ``partial_fit`` and every
    predict batch (``HDCModel._with_state`` hands them on), so an entry
    is keyed by the identity of the two tensors and rebuilt when either
    is another tensor or was edited in place (its ``_version`` moved).
    It lives as long as its ``p`` tensor.  O is not model state: not a
    codebook, not in a manifest or a checkpoint.  ``builds`` counts the
    builds.  A CUDA graph captured over the baseline reads O by address,
    so its owner takes the O's it read from :meth:`holding` and keeps
    them as long as the graph."""

    def __init__(self) -> None:
        self._entries: dict[tuple[int, int], tuple] = {}
        self.builds = 0
        self._held = threading.local()

    def get(self, p: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels import ref as kref

        key = (id(p), id(level))
        stamp = (p._version, level._version, p.data_ptr(), level.data_ptr())
        hit = self._entries.get(key)
        if hit is not None and hit[0]() is p and hit[1]() is level and hit[2] == stamp:
            o = hit[3]
        else:
            o = kref.baseline_onehot_t(p, level)
            if hit is None:
                weakref.finalize(p, self._entries.pop, key, None)
            self._entries[key] = (weakref.ref(p), weakref.ref(level), stamp, o)
            self.builds += 1
        held = getattr(self._held, "operands", None)
        if held is not None:
            held.append(o)
        return o

    @contextlib.contextmanager
    def holding(self):
        """A list of every O this thread gets while inside the block."""
        operands: list[torch.Tensor] = []
        self._held.operands = operands
        try:
            yield operands
        finally:
            self._held.operands = None

    def clear(self) -> None:
        self._entries.clear()


#: the process's cache of the baseline's O (see :class:`BaselineOperandCache`)
BASELINE_OPERANDS = BaselineOperandCache()


def baseline_operands(
    x_q: torch.Tensor, p: torch.Tensor, level: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Kernel 7's operands for the baseline: the one-hot of x, built per
    call, and the codebooks' O from :data:`BASELINE_OPERANDS`; returns
    (U, O, H), as ``ref.baseline_operands`` does."""
    from repro_torch.kernels import ref as kref

    return kref.baseline_onehot_u(x_q, level.shape[0]), BASELINE_OPERANDS.get(p, level), p.shape[0]


def baseline_encode(x_q: torch.Tensor, p: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Baseline bind + bundle ``hv[b] = sum_h P[h] * L[x[b, h]]`` as the
    JAX package contracts it: one (B, V*H) one-hot times (V*H, D) [P*L]
    product, here in its binary form ``2 * (U @ [P == L]) - H`` (the
    plain version of kernel 7 on :func:`baseline_operands`), (B, H) int,
    (H, D), (V, D) ±1 -> (B, D) int32."""
    from repro_torch.kernels import ref as kref

    return kref.encode_unary_mxu(*baseline_operands(x_q, p, level))


def bundle_by_class(hvs: torch.Tensor, labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Per-class int32 sums, (B, D), (B,) -> (C, D), through the
    bundling kernel (``ops.bundle_binarize`` without the sign): kernel 8
    on a card, its plain version on the CPU.

    A label outside ``[0, n_classes)`` is dropped from the sums, as in
    the JAX package; the host-facing entry points reject such labels
    first with :func:`validate_labels`.
    """
    from repro_torch.kernels import ops

    return ops.bundle_binarize(hvs, labels, n_classes, binarize=False)


def validate_labels(labels, n_classes: int) -> None:
    """Raise on labels outside ``[0, n_classes)`` instead of dropping them.

    The message is the JAX package's word for word ("under jit" names the
    drop that the kernels here make too), so the HTTP server's 400 body for
    bad feedback labels is the same from either package."""
    arr = labels.cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
    if arr.size == 0:
        return
    bad = arr[(arr < 0) | (arr >= n_classes)]
    if bad.size:
        raise ValueError(
            f"labels must be in [0, {n_classes}); got out-of-range values "
            f"{np.unique(bad)[:8].tolist()} — under jit such labels are "
            "silently dropped from class_sums while n_seen still counts "
            "them, so they are rejected at the API boundary"
        )


def binarize(hv: torch.Tensor) -> torch.Tensor:
    """Sign binarization; ties (sum == 0) resolve to +1."""
    one = torch.ones((), dtype=torch.int8, device=hv.device)
    return torch.where(hv >= 0, one, -one)
