"""The reference past 1,110 features: ``hdc.Reference`` with the
thresholds of ``sobol``'s definition drawn from the primitive polynomials
of degree up to 15.

There are 3,666 of them, enough for 3,667 features (a colour image of 32
x 32 x 3 takes 3,072), frozen in ``primitive_polys_15.txt``; its first
1,110 are ``primitive_polys.txt``, so the thresholds of the first 1,111
features are ``sobol``'s.  ``sobol.search_primitive(15)`` finds the file
again, and a CPU test holds it to that search.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import hdc, sobol

POLYS_FILE = Path(__file__).with_name("primitive_polys_15.txt")


def frozen_polynomials() -> list[int]:
    return [int(line) for line in POLYS_FILE.read_text().split()]


def direction_integers(n_dims: int, seed: int) -> np.ndarray:
    """(n_dims, 32) left-justified direction integers, as
    ``sobol.direction_integers`` defines them."""
    polys = frozen_polynomials()
    if n_dims - 1 > len(polys):
        raise ValueError(f"{n_dims} dimensions need more than the {len(polys)} frozen polynomials")
    n = sobol.N_BITS
    out = np.zeros((n_dims, n), np.uint64)
    for dim in range(n_dims):
        m = [0] + [1] * n
        if dim > 0:
            poly = polys[dim - 1]
            s = poly.bit_length() - 1
            a = [(poly >> (s - j)) & 1 for j in range(1, s)]
            rng = np.random.default_rng(np.random.SeedSequence([seed, dim]))
            for k in range(1, min(s, n) + 1):
                m[k] = 2 * int(rng.integers(0, 1 << (k - 1))) + 1
            for k in range(s + 1, n + 1):
                val = m[k - s] ^ (m[k - s] << s)
                for j in range(1, s):
                    if a[j - 1]:
                        val ^= m[k - j] << j
                m[k] = val
        out[dim] = [m[k] << (n - k) for k in range(1, n + 1)]
    return out


def threshold_table(n_features: int, d: int, levels: int, *, seed: int, skip: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(n_features, d) int32 thresholds in [0, levels), as
    ``sobol.threshold_table`` defines them."""
    bits = int(levels).bit_length() - 1
    v = torch.from_numpy(direction_integers(n_features, seed).astype(np.int64)).to(device)
    idx = torch.arange(skip, skip + d, dtype=torch.int64, device=device)
    gray = idx ^ (idx >> 1)
    acc = torch.zeros((d, n_features), dtype=torch.int64, device=device)
    for b in range(int(gray.max()).bit_length()):
        acc[((gray >> b) & 1).bool()] ^= v[:, b]
    return (acc >> (sobol.N_BITS - bits)).T.contiguous().to(torch.int32)


class Reference(hdc.Reference):
    """``hdc.Reference`` over up to 3,667 features."""

    def __init__(self, cfg: dict, device: torch.device | str = "cpu",
                 image_dtype: torch.dtype = torch.float32):
        self.h = int(cfg["n_features"])
        self.c = int(cfg["n_classes"])
        self.d = int(cfg["d"])
        self.levels = int(cfg.get("levels", 16))
        self.max_intensity = float(cfg.get("max_intensity", 255.0))
        self.device = torch.device(device)
        self.image_dtype = image_dtype
        self.table = threshold_table(
            self.h, self.d, self.levels, seed=int(cfg.get("seed", 0)),
            skip=int(cfg.get("sobol_skip", 1)), device=self.device)
        self._onehot = None
