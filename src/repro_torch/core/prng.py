"""The JAX package's default random numbers, in numpy.

The baseline encoder's codebooks are drawn with ``jax.random``
(``repro.core.encoding.make_baseline_codebooks``).  The port imports no
JAX, so this module recomputes the same bits: JAX's default generator,
threefry2x32 (5 x 4 rounds, rotations 13, 15, 26, 6 / 17, 29, 16, 24),
in the form JAX uses when ``jax_threefry_partitionable`` is True (the
default of current JAX):

* ``PRNGKey(seed)`` is the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``split(key, n)`` hashes the counters ``(0, i)``, i < n, and the i-th
  new key is the two output words of counter i;
* ``random_bits(key, shape)`` hashes each element's row-major flat index,
  split into (high, low) 32-bit words, and XORs the two output words;
* ``uniform`` keeps the top 23 bits as the mantissa of a float32 in
  [1, 2), subtracts 1, scales by ``maxval - minval``, adds ``minval`` and
  clamps below at ``minval``, in float32.  XLA on the CPU fuses the
  scale and the add into one multiply-add, rounded once; here the
  float32 product is exact in float64, and the sum is rounded to float32
  once.  With ``minval = 0``, the baseline codebooks' case, both forms
  are the same exact product.

The other form (``jax_threefry_partitionable`` False) draws other bits;
the tests assert the flag before comparing.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of the counter words (x0, x1) under a (2,)
    uint32 key; returns the two uint32 output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a (2,) uint32 array."""
    seed = int(seed)
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The flat indices 0..n-1 as (high, low) uint32 words."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` as a (num, 2) uint32 array."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of `shape`, uint32."""
    b0, b1 = threefry2x32(key, *_counters(int(np.prod(shape, dtype=np.int64))))
    return (b0 ^ b1).reshape(shape)


def uniform(
    key: np.ndarray, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0
) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, scaled.astype(np.float32))
