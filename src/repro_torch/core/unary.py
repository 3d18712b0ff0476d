"""Unary bit streams and packed-bit primitives (32 dims per word).

The torch counterpart of ``repro.core.unary``: thermometer codes, the
unary stream table and the uHD unary comparator (paper Figs. 3-4), and
the packing of binarized hypervectors.
Packed words are kept as **int32 bit patterns** of the JAX package's
uint32 words: this torch has no ``>>`` or ``>=`` for ``torch.uint32`` on
the CPU, and ``int32 >>`` is arithmetic.  So shifts run in int64 masked
to 32 bits, and popcount is a SWAR reduction (torch has no popcount op).
``words.numpy().view(np.uint32)`` gives the JAX package's words exactly.
"""

from __future__ import annotations

import torch

WORD = 32  # bits per packed word
_MASK32 = 0xFFFFFFFF


def n_words(n_bits: int) -> int:
    return (n_bits + WORD - 1) // WORD


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & _MASK32


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _tail_mask(n_bits: int, device) -> torch.Tensor:
    """Valid-bit mask of each word of an n_bits stream, (n_words,) int32."""
    return pack_bits(torch.arange(n_words(n_bits) * WORD, device=device) < n_bits)


def to_thermometer(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Unary/thermometer code: value v in [0, n_bits] -> (..., n_bits)
    bool, bit i set iff i < v (v leading ones, LSB first)."""
    levels = torch.arange(n_bits, dtype=torch.int32, device=x.device)
    return levels < x[..., None].to(torch.int32)


def from_thermometer(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_thermometer` (sums the ones) -> int32."""
    return bits.to(torch.int32).sum(-1, dtype=torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n_bits) bool -> (..., n_words) int32 words, LSB-first; pad bits 0."""
    n_bits = bits.shape[-1]
    pad = n_words(n_bits) * WORD - n_bits
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))], dim=-1)
    words = bits.reshape(bits.shape[:-1] + (-1, WORD)).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << torch.arange(
        WORD, dtype=torch.int64, device=bits.device
    )
    return to_i32((words * weights).sum(-1))


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(..., n_words) int32 words -> (..., n_bits) bool (LSB-first)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=words.device)
    bits = (as_u32(words)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n_bits].to(torch.bool)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Set bits of every word (SWAR), as int64 of the same shape."""
    x = as_u32(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK32) >> 24


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total number of set bits along the trailing word axis -> int32."""
    return popcount_words(words).sum(-1).to(torch.int32)


def unary_min(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """min of two unary streams: bit-wise AND (the streams are correlated)."""
    return a_words & b_words


def unary_ge(a_words: torch.Tensor, b_words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """The uHD comparator: a >= b iff AND-reduce(a OR NOT b) over the
    valid bits; padding bits count as ones.  Packed words in, bool (...,)
    out."""
    mask = _tail_mask(n_bits, a_words.device)
    t = a_words | (~b_words & mask) | ~mask
    return (t == -1).all(dim=-1)


def unary_stream_table(n_bits: int, device=None) -> torch.Tensor:
    """The unary stream table (Fig. 3(c)): the packed stream of every
    value 0..n_bits, (n_bits + 1, n_words) int32."""
    return pack_bits(to_thermometer(torch.arange(n_bits + 1, device=device), n_bits))


def fetch_unary(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Associative fetch of pre-stored unary streams: ``table[x]``."""
    return table[x.to(torch.int64)]


def pack_hypervector(hv: torch.Tensor) -> torch.Tensor:
    """Pack a ±1 (or sign-of-sum) hypervector: bit = (hv >= 0)."""
    return pack_bits(hv >= 0)


def unpack_hypervector(words: torch.Tensor, d: int) -> torch.Tensor:
    """Packed bits -> ±1 int8 hypervector."""
    bits = unpack_bits(words, d)
    one = torch.ones((), dtype=torch.int8, device=words.device)
    return torch.where(bits, one, -one)


def hamming_distance_packed(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed hypervectors (XOR + popcount)."""
    return popcount(a_words ^ b_words)


def packed_dot_pm1(a_words: torch.Tensor, b_words: torch.Tensor, d: int) -> torch.Tensor:
    """<a, b> for ±1 vectors stored packed: d - 2 * hamming."""
    return d - 2 * hamming_distance_packed(a_words, b_words)


def majority_threshold(counts: torch.Tensor, h: int) -> torch.Tensor:
    """Concurrent binarization (paper contribution 5): popcount >= TOB.

    `counts` holds the number of +1 contributions among `h` votes (the
    popcount register in Fig. 5); TOB = H/2.  Returns the sign bit."""
    return counts * 2 >= h
