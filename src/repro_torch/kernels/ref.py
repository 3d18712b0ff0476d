"""Plain PyTorch versions of the port's CUDA kernels.

Each function defines the exact semantics its kernel reproduces and is
the torch counterpart of a function in ``repro.kernels.ref`` (or of
``repro.core.encoding.uhd_encode_dynamic``).  Every plain version of an
encode or training step tiles D, so the transient stays (B, H, block_d).  On a CPU tensor the
wrappers in :mod:`repro_torch.kernels.ops` run these; on the card
``chip_smoke.py`` and the cuda-marked tests hold each kernel against
them.  Everything is integer arithmetic (or a float64 matmul of 0/1 and
small integer operands, exact far past these sums, where torch has no
integer matmul on a card), so agreement is exact.  The operand builders
of kernel 7 (``unary_mxu_operands``, ``baseline_operands``) live here
too: the kernel's wrappers and its plain version share them.

uint32 arithmetic (Gray codes, raw Sobol integers) runs in int64 masked
to 32 bits; see :mod:`repro_torch.core.unary`.
"""

from __future__ import annotations

import torch

from repro_torch.core import unary

I32_MAX = 2**31 - 1


def sobol_tile(direction: torch.Tensor, d0: int, tile: int) -> torch.Tensor:
    """Sobol integers of points [d0, d0 + tile) for every direction row.

    direction: (H, 32) direction integers (any unsigned or int dtype).
    Returns (H, tile) int64 values in [0, 2**32): point k is the XOR of
    the direction entries selected by the bits of gray(k), with k taken
    modulo 2**32 as the JAX package's uint32 index is.
    """
    dev = direction.device
    idx = (d0 + torch.arange(tile, dtype=torch.int64, device=dev)) & 0xFFFFFFFF
    gray = idx ^ (idx >> 1)
    dirs = direction.to(torch.int64) & 0xFFFFFFFF
    acc = torch.zeros((direction.shape[0], tile), dtype=torch.int64, device=dev)
    for bit in range(direction.shape[-1]):
        mask = (gray >> bit) & 1
        acc ^= mask[None, :] * dirs[:, bit : bit + 1]
    return acc


def _hvs(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(B, H) int32 intensities, (H, tile) int32 thresholds -> (B, tile)
    int32 hypervector columns, 2 * #{h : x >= S} - H."""
    ge = x[:, :, None] >= s[None, :, :]
    return 2 * ge.sum(dim=1, dtype=torch.int32) - x.shape[1]


def _tile_hvs(x: torch.Tensor, direction: torch.Tensor, d0: int, tile: int) -> torch.Tensor:
    """(B, H) int32 intensities -> (B, tile) int32 hypervector columns."""
    return _hvs(x, unary.to_i32(sobol_tile(direction, d0, tile)))


def _encode_tiles(x_q, d, tile_hvs, block_d):
    """(B, d) int32 hypervectors, the columns that ``tile_hvs(x, j0,
    width)`` gives per D-tile, concatenated."""
    x = x_q.to(torch.int32)
    tiles = [tile_hvs(x, j0, min(block_d, d - j0)) for j0 in range(0, d, block_d)]
    return torch.cat(tiles, dim=1) if tiles else x.new_zeros((x.shape[0], 0))


def encode_bundle(x_q: torch.Tensor, sobol_q: torch.Tensor, *, block_d: int = 512) -> torch.Tensor:
    """Encode+bundle over a stored threshold table:
    hv[b, d] = sum_h (2*[x[b, h] >= S[h, d]] - 1), (B, H), (H, D) -> (B, D)
    int32.  The table may be stored int8 or int32; it is compared as
    int32.  D is tiled, so the peak transient is (B, H, block_d) booleans.
    """
    return _encode_tiles(
        x_q, sobol_q.shape[-1],
        lambda x, j0, w: _hvs(x, sobol_q[:, j0 : j0 + w].to(torch.int32)), block_d,
    )


def encode_bundle_dynamic(
    x_q: torch.Tensor, direction: torch.Tensor, d: int, *, skip: int = 1,
    block_d: int = 512,
) -> torch.Tensor:
    """hv[b, j] = sum_h (2*[x[b, h] >= S[h, skip + j]] - 1), (B, H) -> (B, d).

    Thresholds are generated per D-tile and discarded; the peak
    transient is (B, H, block_d) booleans.
    """
    return _encode_tiles(
        x_q, d, lambda x, j0, w: _tile_hvs(x, direction, skip + j0, w), block_d
    )


def class_onehot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(B,) labels -> (C, B) int32 indicator; an out-of-range label gives
    an all-zero column (it is dropped from the sums)."""
    lab = labels.to(torch.int64)
    classes = torch.arange(n_classes, dtype=torch.int64, device=labels.device)
    return (lab[None, :] == classes[:, None]).to(torch.int32)


def _segment_sums(x_q, labels, n_classes, d, tile_hvs, block_d):
    """(C, d) int32 class sums of the hypervector columns that
    ``tile_hvs(x, j0, width)`` gives per D-tile; rows whose label is
    outside ``[0, n_classes)`` are dropped first."""
    x = x_q.to(torch.int32)
    lab = labels.to(torch.int64)
    keep = (lab >= 0) & (lab < n_classes)
    x, lab = x[keep], lab[keep]
    out = torch.zeros((n_classes, d), dtype=torch.int32, device=x_q.device)
    for j0 in range(0, d, block_d):
        hv = tile_hvs(x, j0, min(block_d, d - j0))
        out[:, j0 : j0 + hv.shape[1]].index_add_(0, lab, hv)
    return out


def fit_bundle(
    x_q: torch.Tensor, sobol_q: torch.Tensor, labels: torch.Tensor, n_classes: int,
    *, block_d: int = 512,
) -> torch.Tensor:
    """Fused training step over a stored table (the JAX package's D-tile
    scan): (B, H), (H, D) int8 or int32, (B,) -> (C, D) int32 class sums,
    sums[c, j] = sum over rows labelled c of hv[b, j].  Labels outside
    ``[0, n_classes)`` contribute nothing."""
    return _segment_sums(
        x_q, labels, n_classes, sobol_q.shape[-1],
        lambda x, j0, w: _hvs(x, sobol_q[:, j0 : j0 + w].to(torch.int32)), block_d,
    )


def fit_bundle_dynamic(
    x_q: torch.Tensor, direction: torch.Tensor, labels: torch.Tensor,
    n_classes: int, d: int, *, skip: int = 1, block_d: int = 512,
) -> torch.Tensor:
    """Fused table-free training step: (B, H), (H, 32), (B,) -> (C, d)
    int32 class sums, sums[c, j] = sum over rows labelled c of hv[b, j].

    Each (B, block_d) hypervector slab is folded into the class sums by
    an int32 segment sum before the next tile; labels outside
    ``[0, n_classes)`` contribute nothing.
    """
    return _segment_sums(
        x_q, labels, n_classes, d,
        lambda x, j0, w: _tile_hvs(x, direction, skip + j0, w), block_d,
    )


#: the contraction depth of kernel 7's operands is a multiple of this
K_ALIGN = 32


def _k_padded(k: int) -> int:
    return -(-k // K_ALIGN) * K_ALIGN


def unary_mxu_operands(
    x_q: torch.Tensor, sobol_q: torch.Tensor, levels: int
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Kernel 7's operands for the uHD table encode (the JAX package's
    ``unary_matmul`` form): the inclusive thermometer U[b, h*levels + v]
    = [v <= x[b, h]], (B, Kp) int8, and the one-hot of the thresholds
    stored transposed, O[d, h*levels + v] = [S[h, d] == v], (D, Kp) int8,
    with K = H * levels padded with zero columns to Kp, a multiple of 32.
    ``2 * (U @ O.T) - H`` is the encode; returns (U, O, H)."""
    b, h = x_q.shape
    d = sobol_q.shape[-1]
    dev = x_q.device
    kp = _k_padded(h * levels)
    v = torch.arange(levels, dtype=torch.int32, device=dev)
    u = torch.zeros((b, kp), dtype=torch.int8, device=dev)
    u[:, : h * levels].view(b, h, levels).copy_(v <= x_q.to(torch.int32)[:, :, None])
    o = torch.zeros((d, kp), dtype=torch.int8, device=dev)
    o[:, : h * levels].view(d, h, levels).copy_(
        sobol_q.t().to(torch.int32)[:, :, None] == v
    )
    return u, o, h


def baseline_onehot_u(x_q: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Kernel 7's per-batch operand for the baseline: the one-hot
    U[b, v*H + h] = [x[b, h] == v], (B, Kp) int8 (the JAX package's
    ``baseline_encode`` layout), K = n_levels * H padded to Kp."""
    b, h = x_q.shape
    k = n_levels * h
    v = torch.arange(n_levels, dtype=torch.int32, device=x_q.device)
    u = torch.zeros((b, _k_padded(k)), dtype=torch.int8, device=x_q.device)
    u[:, :k].view(b, n_levels, h).copy_(x_q.to(torch.int32)[:, None, :] == v[None, :, None])
    return u


def baseline_onehot_t(p: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """Kernel 7's per-model operand for the baseline: O[d, v*H + h] =
    [P[h, d] * L[v, d] = +1] = [P[h, d] == L[v, d]], (D, Kp) int8, K =
    (levels + 1) * H padded to Kp.  It depends on the codebooks alone
    (``core.encoding.baseline_operand_cache`` keeps it)."""
    h, d = p.shape
    n_levels = level.shape[0]
    k = n_levels * h
    o = torch.zeros((d, _k_padded(k)), dtype=torch.int8, device=p.device)
    o[:, :k].view(d, n_levels, h).copy_(p.t()[:, None, :] == level.t()[:, :, None])
    return o


def baseline_operands(
    x_q: torch.Tensor, p: torch.Tensor, level: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Kernel 7's operands for the baseline bind + bundle
    ``hv[b, d] = sum_h P[h, d] * L[x[b, h], d]``: (:func:`baseline_onehot_u`,
    :func:`baseline_onehot_t`, H).  Each (b, h) has exactly one v with U =
    1, so the ±1 sum is ``2 * (U @ O.T) - H``."""
    return baseline_onehot_u(x_q, level.shape[0]), baseline_onehot_t(p, level), p.shape[0]


def encode_unary_mxu(
    u: torch.Tensor, onehot_t: torch.Tensor, h: int, *, block_d: int = 2048
) -> torch.Tensor:
    """Binary contraction with the affine epilogue:
    ``out[b, d] = 2 * sum_k u[b, k] * onehot_t[d, k] - h``, (B, K) 0/1 and
    (D, K) 0/1 (the second operand stored transposed, K contiguous) ->
    (B, D) int32.  A float64 matmul, exact while the counts stay below
    2**53 (torch has no integer matmul on a card); D is tiled, so the
    float64 transient is (block_d, K)."""
    a = u.to(torch.float64)
    cols = [
        a @ onehot_t[j0 : j0 + block_d].to(torch.float64).t()
        for j0 in range(0, onehot_t.shape[0], block_d)
    ]
    count = torch.cat(cols, dim=1) if cols else a.new_zeros((u.shape[0], 0))
    return (2 * count.to(torch.int64) - h).to(torch.int32)


def bundle_binarize(
    hvs: torch.Tensor, onehot_labels: torch.Tensor, *, binarize: bool = True,
    block_d: int = 4096,
) -> torch.Tensor:
    """Class bundling with the fused sign: ``sums = onehot_labels @ hvs``,
    (C, B) 0/1 and (B, D) int -> (C, D) int8 ±1 (ties -> +1) with
    ``binarize``, else the int32 sums.  A float64 matmul over D-tiles,
    exact while |sums| < 2**53 (the JAX package's float32 is exact only
    below 2**24)."""
    oh = onehot_labels.to(torch.float64)
    cols = [
        oh @ hvs[:, j0 : j0 + block_d].to(torch.float64)
        for j0 in range(0, hvs.shape[1], block_d)
    ]
    sums = torch.cat(cols, dim=1) if cols else oh.new_zeros((oh.shape[0], 0))
    if binarize:
        one = torch.ones((), dtype=torch.int8, device=hvs.device)
        return torch.where(sums >= 0, one, -one)
    return sums.to(torch.int64).to(torch.int32)


def _sort_pairs(dist: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row ascending by (distance, index): a stable sort by
    index, then a stable sort by distance (``torch.topk`` does not pin
    the order of ties)."""
    o = torch.argsort(idx, dim=-1, stable=True)
    dist, idx = dist.gather(-1, o), idx.gather(-1, o)
    o = torch.argsort(dist, dim=-1, stable=True)
    return dist.gather(-1, o), idx.gather(-1, o)


def topk_pinned(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest distances of each row of a (B, C) matrix, ties to
    the lowest column index.  Returns ((B, k) int32 indices, (B, k)
    int32 distances), each row ascending by (distance, index)."""
    b, c = dist.shape
    if not 1 <= k <= c:
        raise ValueError(f"k must be in [1, {c}], got {k}")
    idx = torch.arange(c, dtype=torch.int32, device=dist.device).expand(b, c)
    sd, si = _sort_pairs(dist.to(torch.int32), idx)
    return si[:, :k], sd[:, :k]


def hamming_distances(q_words: torch.Tensor, c_words: torch.Tensor) -> torch.Tensor:
    """(B, W) x (C, W) packed words -> (B, C) int32 Hamming distances
    (pad bits are zero in both operands and cancel in the XOR)."""
    x = q_words[:, None, :] ^ c_words[None, :, :]
    return unary.popcount_words(x).sum(-1).to(torch.int32)


def hamming_packed(
    q_words: torch.Tensor, c_words: torch.Tensor, d: int, *, block_c: int = 4096
) -> torch.Tensor:
    """Packed ±1 similarity, (B, W) x (C, W) words -> (B, C) int32 scores
    d - 2 * popcount(q ^ c) (the ±1 dot product of two sign vectors of
    length d; pad bits are zero in both operands and cancel).  Rows are
    tiled, so the transient stays (B, block_c, W)."""
    tiles = [
        d - 2 * hamming_distances(q_words, c_words[c0 : c0 + block_c])
        for c0 in range(0, c_words.shape[0], block_c)
    ]
    if not tiles:
        return torch.zeros((q_words.shape[0], 0), dtype=torch.int32, device=q_words.device)
    return torch.cat(tiles, dim=1).to(torch.int32)


def hamming_topk_oracle(
    q_words: torch.Tensor, c_words: torch.Tensor, d: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sort oracle for packed top-k retrieval: the k nearest rows per
    query as ((B, k) indices, (B, k) distances), lowest index on ties."""
    return topk_pinned(hamming_distances(q_words, c_words), k)


def hamming_topk(
    q_words: torch.Tensor, c_words: torch.Tensor, d: int, k: int,
    *, block_c: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled top-k: scan row tiles carrying a running k-best, so the
    (B, C) distance matrix never exists at once.  Padded slots hold the
    int32-max sentinel.  Equal to :func:`hamming_topk_oracle`."""
    b = q_words.shape[0]
    c = c_words.shape[0]
    if not 1 <= k <= c:
        raise ValueError(f"k must be in [1, {c}], got {k}")
    dev = q_words.device
    best_d = torch.full((b, k), I32_MAX, dtype=torch.int32, device=dev)
    best_i = torch.full((b, k), I32_MAX, dtype=torch.int32, device=dev)
    for c0 in range(0, c, block_c):
        tile = c_words[c0 : c0 + block_c]
        dist_t = hamming_distances(q_words, tile)
        gidx = torch.arange(c0, c0 + tile.shape[0], dtype=torch.int32, device=dev)
        sd, si = _sort_pairs(
            torch.cat([best_d, dist_t], dim=1),
            torch.cat([best_i, gidx.expand(b, -1)], dim=1),
        )
        best_d, best_i = sd[:, :k], si[:, :k]
    return best_i, best_d
