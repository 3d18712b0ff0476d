"""Sobol direction numbers and threshold tables for the uHD encoders (numpy).

A copy of ``repro.core.sobol`` (the port imports nothing of the JAX
package): primitive polynomials over GF(2), seeded odd initial direction
integers, the M-bit quantized direction matrix that is the whole codebook
of ``uhd_dynamic``, the Gray-code sequence that fills the (H, D)
threshold table of ``uhd``, and the 1-D star discrepancy of the
low-discrepancy tests.  The numbers are bit-identical to the JAX
package's for every ``(n_dims, levels, seed, skip)``;
``tests/test_torch_core.py`` and ``tests/test_torch_table.py`` pin that.
"""

from __future__ import annotations

import functools

import numpy as np

N_BITS = 32  # direction-number precision; supports sequences up to 2**32 points


# ---------------------------------------------------------------------------
# GF(2) polynomial arithmetic (polynomials as python ints, bit i = coeff x^i)
# ---------------------------------------------------------------------------


def _poly_mulmod(a: int, b: int, mod: int, deg: int) -> int:
    """(a * b) mod `mod` over GF(2); `deg` = degree of `mod`."""
    res = 0
    while b:
        if b & 1:
            res ^= a
        b >>= 1
        a <<= 1
        if a >> deg & 1:
            a ^= mod
    return res


def _poly_powmod(base: int, exp: int, mod: int, deg: int) -> int:
    res = 1
    while exp:
        if exp & 1:
            res = _poly_mulmod(res, base, mod, deg)
        base = _poly_mulmod(base, base, mod, deg)
        exp >>= 1
    return res


def _prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        if n % p == 0:
            out.append(p)
            while n % p == 0:
                n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


def _is_primitive(poly: int, deg: int) -> bool:
    """True iff `poly` (degree `deg`, constant term 1) is primitive over GF(2).

    Primitive <=> x has multiplicative order 2^deg - 1 in GF(2)[x]/(poly).
    """
    if not (poly & 1) or not (poly >> deg) & 1:
        return False
    order = (1 << deg) - 1
    if _poly_powmod(2, order, poly, deg) != 1:  # x^order must be 1
        return False
    for q in _prime_factors(order):
        if _poly_powmod(2, order // q, poly, deg) == 1:
            return False
    return True


_POLY_CACHE: list[int] = []
_POLY_NEXT_DEGREE = 1


def primitive_polynomials(count: int) -> tuple[int, ...]:
    """First `count` primitive polynomials over GF(2), by increasing degree.

    Returned as ints with bit i = coefficient of x^i (leading and constant
    bits always set).  Degree 13 already yields 1110 polynomials, enough
    for hypervector encoders over ~1100 input features; the search simply
    continues to higher degrees when more are requested.  The cache grows
    monotonically so repeated calls with increasing `count` are cheap.
    """
    global _POLY_NEXT_DEGREE
    while len(_POLY_CACHE) < count:
        deg = _POLY_NEXT_DEGREE
        lo, hi = 1 << deg, 1 << (deg + 1)
        for cand in range(lo | 1, hi, 2):  # constant term must be 1
            if _is_primitive(cand, deg):
                _POLY_CACHE.append(cand)
        _POLY_NEXT_DEGREE += 1
    return tuple(_POLY_CACHE[:count])


# ---------------------------------------------------------------------------
# Direction numbers
# ---------------------------------------------------------------------------


def _direction_numbers_for_dim(dim: int, seed: int) -> np.ndarray:
    """Direction integers v_1..v_N_BITS for Sobol dimension `dim` (uint64).

    v_k is stored left-justified in N_BITS bits: v_k = m_k * 2**(N_BITS-k)
    with m_k odd, m_k < 2^k.
    """
    m = np.zeros(N_BITS + 1, dtype=np.uint64)  # 1-indexed
    if dim == 0:
        m[1:] = 1  # van der Corput
    else:
        poly = primitive_polynomials(dim)[dim - 1]
        s = poly.bit_length() - 1  # degree
        # coefficients a_1..a_{s-1} (between leading term and x^0)
        a = [(poly >> (s - j)) & 1 for j in range(1, s)]
        rng = np.random.default_rng(np.random.SeedSequence([seed, dim]))
        for k in range(1, min(s, N_BITS) + 1):
            # deterministic odd init, m_k < 2^k
            m[k] = np.uint64(2 * rng.integers(0, 1 << (k - 1)) + 1)
        for k in range(s + 1, N_BITS + 1):
            val = int(m[k - s]) ^ (int(m[k - s]) << s)
            for j in range(1, s):
                if a[j - 1]:
                    val ^= int(m[k - j]) << j
            m[k] = np.uint64(val)
    ks = np.arange(1, N_BITS + 1, dtype=np.uint64)
    return (m[1:] << (np.uint64(N_BITS) - ks)).astype(np.uint64)


@functools.lru_cache(maxsize=32)
def _direction_matrix_cached(n_dims: int, seed: int) -> np.ndarray:
    return np.stack([_direction_numbers_for_dim(d, seed) for d in range(n_dims)])


def direction_matrix(n_dims: int, seed: int = 0) -> np.ndarray:
    """(n_dims, N_BITS) uint64 left-justified direction integers."""
    return _direction_matrix_cached(n_dims, seed)


def quantized_direction_matrix(n_dims: int, levels: int, *, seed: int = 0) -> np.ndarray:
    """M-bit quantized direction integers, (n_dims, N_BITS) narrow unsigned.

    Right-shift distributes over XOR — bit i of ``(a ^ b) >> s`` is bit
    ``i+s`` of ``a`` XOR bit ``i+s`` of ``b`` — so Gray-code generation
    from these pre-shifted direction numbers yields *exactly* the values
    of :func:`quantized_sobol` for every point index.  Only
    ``M = log2(levels)`` bits per entry survive, stored in the narrowest
    dtype that holds ``levels - 1``: this is the whole encoder state of
    the table-free datapath — O(n_dims * N_BITS) bytes instead of the
    O(n_dims * D) threshold table (the paper's M-bit BRAM, kept as a
    generator instead of materialized).
    """
    if levels & (levels - 1):
        raise ValueError(f"levels must be a power of two, got {levels}")
    m = int(levels).bit_length() - 1
    v = direction_matrix(n_dims, seed) >> np.uint64(N_BITS - m)
    return v.astype(quantized_direction_dtype(levels))


def quantized_direction_dtype(levels: int) -> np.dtype:
    """Narrowest unsigned dtype holding ``levels - 1`` (M quantization
    bits) — the storage dtype of :func:`quantized_direction_matrix`,
    shared with the encoder's ``codebook_specs`` so the checkpoint
    template can never drift from what ``build_codebooks`` produces."""
    m = int(levels).bit_length() - 1
    return np.dtype(np.uint8 if m <= 8 else np.uint16 if m <= 16 else np.uint32)


# ---------------------------------------------------------------------------
# Sequence generation (vectorized Gray-code construction)
# ---------------------------------------------------------------------------


def sobol_integers(n_dims: int, n_points: int, *, seed: int = 0, skip: int = 1) -> np.ndarray:
    """Raw Sobol integers in [0, 2^N_BITS), shape (n_points, n_dims) uint64.

    Point k is XOR of direction numbers selected by the bits of gray(k).
    `skip` drops the leading points (the all-zeros point 0 by default).
    """
    v = direction_matrix(n_dims, seed)  # (n_dims, N_BITS)
    idx = np.arange(skip, skip + n_points, dtype=np.uint64)
    gray = idx ^ (idx >> np.uint64(1))
    out = np.zeros((n_points, n_dims), dtype=np.uint64)
    for bit in range(int(gray.max()).bit_length() if n_points else 0):
        mask = (gray >> np.uint64(bit)) & np.uint64(1)
        out ^= mask[:, None] * v[None, :, bit]
    return out


def sobol_sequence(
    n_dims: int, n_points: int, *, seed: int = 0, skip: int = 1, dtype=np.float32
) -> np.ndarray:
    """Sobol points in [0, 1), shape (n_points, n_dims)."""
    ints = sobol_integers(n_dims, n_points, seed=seed, skip=skip)
    return (ints.astype(np.float64) / float(1 << N_BITS)).astype(dtype)


def quantized_sobol(
    n_dims: int, n_points: int, levels: int, *, seed: int = 0, skip: int = 1
) -> np.ndarray:
    """xi-level quantized Sobol scalars, int32 in [0, levels): the top
    log2(levels) bits of each Sobol integer (the paper's M-bit BRAM)."""
    if levels & (levels - 1):
        raise ValueError(f"levels must be a power of two, got {levels}")
    shift = np.uint64(N_BITS - int(levels).bit_length() + 1)
    ints = sobol_integers(n_dims, n_points, seed=seed, skip=skip)
    return (ints >> shift).astype(np.int32)


def sobol_table_for_features(
    n_features: int, d: int, levels: int | None = None, *, seed: int = 0, skip: int = 1
) -> np.ndarray:
    """Sobol threshold table laid out (n_features, D) as the ``uhd``
    encoder uses it: feature h takes Sobol dimension h, and the D points
    along it are its thresholds.  ``levels=None`` gives float32 in
    [0, 1); otherwise int32 quantized to [0, levels)."""
    if levels is None:
        return sobol_sequence(n_features, d, seed=seed, skip=skip).T.copy()
    return quantized_sobol(n_features, d, levels, seed=seed, skip=skip).T.copy()


def star_discrepancy_1d(points: np.ndarray) -> float:
    """Exact 1-D star discrepancy (for LD property tests).

    D*_N = max_i max(|x_(i) - i/N|, |x_(i) - (i+1)/N|) over sorted points.
    LD sequences achieve O(log N / N); uniform pseudo-random is O(1/sqrt N).
    """
    x = np.sort(np.asarray(points, dtype=np.float64))
    n = len(x)
    i = np.arange(n)
    return float(np.maximum(np.abs(x - i / n), np.abs(x - (i + 1) / n)).max())
