"""The work a step must do, counted from its shapes, and the chip's peaks.

A count is of the operation, not of the kernel that implements it, so it
reads the same whatever a later change runs: the encode of B images of H
features at width D is 2 * B * H * D integer operations (one compare and
one add a feature and dimension), whichever of the port's encode kernels
(the compare-count of kernels 1 and 2, the int8 tensor-core product of
kernel 7) does it, and every byte is counted once, read or written.  The
least time of a step is the larger of its bytes over the memory's rate
and its operations over the densest integer rate of the chip, so no
implementation can beat it; shares of it stay at or below 1.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W limit (the same constants as ``repro_torch.analysis.roofline``):
HBM3 3.35 TB/s; int8 tensor cores 1,979 Tops/s, the densest integer rate
on the chip.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 1979e12
PEAK_SOURCE = "NVIDIA H100 SXM data sheet (dense, 700 W): HBM3 3.35 TB/s, int8 tensor 1,979 Tops/s"


@dataclass(frozen=True)
class Work:
    ops: int
    bytes: int

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    @property
    def least_s(self) -> float:
        """The least time on one chip: bytes at the memory's rate or
        operations at the integer peak, whichever is longer."""
        return max(self.bytes / HBM_BYTES_PER_S, self.ops / INT_OPS_PER_S)


def codebook_bytes(encoder: str, h: int, d: int) -> int:
    """The encoder's codebook: the (H, D) int8 table of ``uhd`` (levels up
    to 127), the (H, 32) uint8 direction numbers of ``uhd_dynamic``."""
    return h * d if encoder == "uhd" else h * 32


def encode(b: int, h: int, d: int, encoder: str) -> Work:
    """Encode B float32 images: 2 * B * H * D operations; the images and
    the codebook read once."""
    return Work(2 * b * h * d, 4 * b * h + codebook_bytes(encoder, h, d))


def classify(b: int, h: int, d: int, c: int, encoder: str) -> Work:
    """A classify step: the encode, the (C, D) sign words read, B int32 labels written."""
    return encode(b, h, d, encoder) + Work(0, c * d // 8 + 4 * b)


def search(b: int, h: int, d: int, rows: int, k: int, encoder: str) -> Work:
    """A search step: the encode, the store's packed rows read once, and
    B x k int32 rows and distances written."""
    return encode(b, h, d, encoder) + Work(0, rows * d // 8 + 8 * b * k)


def fit(n: int, h: int, d: int, c: int, encoder: str) -> Work:
    """A fit job of N labelled images: 2 * (N * H + C * H * D) operations
    (each image feature counted into its class's histogram, then a
    compare-count a class, feature and dimension); the float32 images,
    int32 labels and codebook read once and the (C, D) int32 sums written."""
    return Work(2 * (n * h + c * h * d),
                4 * n * h + 4 * n + codebook_bytes(encoder, h, d) + 4 * c * d)

