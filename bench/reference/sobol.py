"""Sobol thresholds of the uHD encoders, written from the definition.

Feature h of an image takes Sobol dimension h; its D thresholds are the
points ``skip .. skip + D - 1`` of that dimension, each cut to its top
``log2(levels)`` bits.  Dimension 0 is the van der Corput sequence;
dimension j > 0 uses the j-th primitive polynomial over GF(2) (ordered by
degree, then by value) and odd initial direction integers m_k < 2**k drawn
from ``numpy.random.default_rng(SeedSequence([seed, j]))``.  Point i is
the XOR of the direction integers picked by the bits of gray(i) = i ^ (i >> 1).

The primitive polynomials up to degree 13 (1,110 of them, enough for 1,110
features) are frozen in ``primitive_polys.txt``; :func:`search_primitive`
finds them again, and a CPU test holds the file to that search.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

N_BITS = 32
POLYS_FILE = Path(__file__).with_name("primitive_polys.txt")


def _mulmod(a: int, b: int, mod: int, deg: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        b >>= 1
        a <<= 1
        if (a >> deg) & 1:
            a ^= mod
    return out


def _powmod(a: int, e: int, mod: int, deg: int) -> int:
    out = 1
    while e:
        if e & 1:
            out = _mulmod(out, a, mod, deg)
        a = _mulmod(a, a, mod, deg)
        e >>= 1
    return out


def _is_primitive(poly: int, deg: int) -> bool:
    """x has order 2**deg - 1 modulo `poly` (constant term set)."""
    order = (1 << deg) - 1
    if _powmod(2, order, poly, deg) != 1:
        return False
    n, p, factors = order, 2, []
    while p * p <= n:
        if n % p == 0:
            factors.append(p)
            while n % p == 0:
                n //= p
        p += 1
    if n > 1:
        factors.append(n)
    return all(_powmod(2, order // q, poly, deg) != 1 for q in factors)


def search_primitive(max_degree: int) -> list[int]:
    """Every primitive polynomial of degree 1..max_degree, bit i the
    coefficient of x**i, by degree and then by value."""
    return [
        cand
        for deg in range(1, max_degree + 1)
        for cand in range((1 << deg) | 1, 1 << (deg + 1), 2)
        if _is_primitive(cand, deg)
    ]


def frozen_polynomials() -> list[int]:
    return [int(line) for line in POLYS_FILE.read_text().split()]


def direction_integers(n_dims: int, seed: int) -> np.ndarray:
    """(n_dims, 32) left-justified direction integers v_k = m_k * 2**(32 - k)."""
    polys = frozen_polynomials()
    if n_dims - 1 > len(polys):
        raise ValueError(f"{n_dims} dimensions need more than the {len(polys)} frozen polynomials")
    out = np.zeros((n_dims, N_BITS), np.uint64)
    for dim in range(n_dims):
        m = [0] * (N_BITS + 1)
        if dim == 0:
            m[1:] = [1] * N_BITS
        else:
            poly = polys[dim - 1]
            s = poly.bit_length() - 1
            a = [(poly >> (s - j)) & 1 for j in range(1, s)]
            rng = np.random.default_rng(np.random.SeedSequence([seed, dim]))
            for k in range(1, min(s, N_BITS) + 1):
                m[k] = 2 * int(rng.integers(0, 1 << (k - 1))) + 1
            for k in range(s + 1, N_BITS + 1):
                val = m[k - s] ^ (m[k - s] << s)
                for j in range(1, s):
                    if a[j - 1]:
                        val ^= m[k - j] << j
                m[k] = val
        out[dim] = [m[k] << (N_BITS - k) for k in range(1, N_BITS + 1)]
    return out


def threshold_table(n_features: int, d: int, levels: int, *, seed: int, skip: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(n_features, d) int32 thresholds in [0, levels)."""
    bits = int(levels).bit_length() - 1
    v = torch.from_numpy(direction_integers(n_features, seed).astype(np.int64)).to(device)
    idx = torch.arange(skip, skip + d, dtype=torch.int64, device=device)
    gray = idx ^ (idx >> 1)
    acc = torch.zeros((d, n_features), dtype=torch.int64, device=device)
    for b in range(int(gray.max()).bit_length()):
        on = ((gray >> b) & 1).bool()
        acc[on] ^= v[:, b]
    return (acc >> (N_BITS - bits)).T.contiguous().to(torch.int32)
