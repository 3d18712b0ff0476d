"""Similarity measures for HDC classification (see ``repro.core.metrics``)."""

from __future__ import annotations

import torch

from repro_torch.core import unary


def cosine_similarity(queries: torch.Tensor, class_hvs: torch.Tensor) -> torch.Tensor:
    """Cosine similarity (B, D) x (C, D) -> (B, C) float32."""
    q = queries.to(torch.float32)
    c = class_hvs.to(torch.float32)
    qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-9)
    cn = c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-9)
    return qn @ cn.T


def dot_similarity(queries: torch.Tensor, class_hvs: torch.Tensor) -> torch.Tensor:
    return queries.to(torch.float32) @ class_hvs.to(torch.float32).T


def hamming_similarity_packed(
    q_words: torch.Tensor, c_words: torch.Tensor, d: int
) -> torch.Tensor:
    """Packed-binary similarity d - 2*hamming, (B, W) x (C, W) -> (B, C)."""
    return unary.packed_dot_pm1(q_words[:, None, :], c_words[None, :, :], d)


SIMILARITIES = {
    "cosine": cosine_similarity,
    "dot": dot_similarity,
}


def classify(sim: torch.Tensor) -> torch.Tensor:
    """argmax over classes, (B, C) -> (B,) int32; the lowest index wins
    ties (``torch.argmax`` returns the first maximal index)."""
    return torch.argmax(sim, dim=-1).to(torch.int32)
