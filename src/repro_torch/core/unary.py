"""Packed-bit primitives for binarized hypervectors (32 dims per word).

The torch counterpart of the packing half of ``repro.core.unary``.
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
