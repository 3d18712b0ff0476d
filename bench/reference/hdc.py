"""The plain PyTorch reference of what the benchmark's cells compute.

Written from the uHD definitions, with no kernel and nothing of the
program: quantization, the compare-count encode, class sums, the
packing policy (row centring, sign bits), Hamming scoring and the top-k
with its pinned (distance, index) order.  Every function is integer-exact
or repeats the program's stated float32 arithmetic step for step, so the
reference and a correct program agree bit for bit.

``image_dtype`` is the precision the images are read in before
quantization: the configuration states float32; the control passes
``torch.bfloat16``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import sobol

#: constants such as 1 / 255 are rounded to float32 once, as the program states
_F32 = np.float32


@contextlib.contextmanager
def exact_float32():
    """float32 products in full float32 (no TF32) inside the block."""
    tf32, prec = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def quantize(images: torch.Tensor, levels: int, max_intensity: float,
             image_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, H) intensities -> (N, H) int32 levels in [0, levels]:
    ``floor(clip(x * float32(1 / max), 0, 1) * levels)`` in float32."""
    x = images.to(image_dtype).to(torch.float32)
    r = float(_F32(1.0) / _F32(max_intensity))
    x = torch.clamp(x * torch.tensor(r, dtype=torch.float32, device=x.device), 0.0, 1.0)
    return torch.floor(x * levels).to(torch.int32)


class Reference:
    """One configuration's codebook-free reference on one device."""

    def __init__(self, hdc: dict, device: torch.device | str = "cpu",
                 image_dtype: torch.dtype = torch.float32):
        self.h = int(hdc["n_features"])
        self.c = int(hdc["n_classes"])
        self.d = int(hdc["d"])
        self.levels = int(hdc.get("levels", 16))
        self.max_intensity = float(hdc.get("max_intensity", 255.0))
        self.device = torch.device(device)
        self.image_dtype = image_dtype
        self.table = sobol.threshold_table(
            self.h, self.d, self.levels, seed=int(hdc.get("seed", 0)),
            skip=int(hdc.get("sobol_skip", 1)), device=self.device)
        self._onehot: torch.Tensor | None = None  # (H * levels, D): [S[h, d] == l]

    def quantize(self, images: torch.Tensor) -> torch.Tensor:
        return quantize(images.to(self.device), self.levels, self.max_intensity,
                        self.image_dtype)

    def encode(self, images: torch.Tensor, block: int = 8192) -> torch.Tensor:
        """(N, H) images -> (N, D) int32: 2 * #{h : x[n, h] >= S[h, d]} - H.

        The count is a float32 product of 0/1 forms, exact as every partial
        sum is an integer below 2**24: ``[x[n, h] >= l]`` over the levels l
        of each feature, times ``[S[h, d] == l]``."""
        x = self.quantize(images)
        lv = torch.arange(self.levels, device=self.device, dtype=torch.int32)
        if self._onehot is None:
            self._onehot = (self.table[:, None, :] == lv[None, :, None]).reshape(
                self.h * self.levels, self.d).to(torch.float32)
        out = torch.empty((x.shape[0], self.d), dtype=torch.int32, device=self.device)
        with exact_float32():
            for i in range(0, x.shape[0], block):
                ge = (x[i:i + block, :, None] >= lv).reshape(-1, self.h * self.levels)
                count = (ge.to(torch.float32) @ self._onehot).round().to(torch.int32)
                out[i:i + block] = 2 * count - self.h
        return out

    def class_sums(self, images: torch.Tensor, labels: torch.Tensor,
                   block: int = 8192) -> torch.Tensor:
        """(C, D) int64 sums of the encodings of each class, from per-class
        counts: #{n in c : x[n, h] >= l} for every feature h and level l,
        gathered at l = S[h, d]."""
        nv = self.levels + 1
        counts = torch.zeros(self.c * self.h * nv, dtype=torch.int64, device=self.device)
        feat = torch.arange(self.h, device=self.device)
        for i in range(0, images.shape[0], block):
            x = self.quantize(images[i:i + block]).to(torch.int64)
            y = labels[i:i + block].to(self.device, torch.int64)
            key = (y[:, None] * self.h + feat[None]) * nv + x
            counts += torch.bincount(key.reshape(-1), minlength=counts.numel())
        counts = counts.view(self.c, self.h, nv)
        at_least = counts.flip(-1).cumsum(-1).flip(-1)  # [c, h, l] = #{x >= l}
        n_c = torch.bincount(labels.to(self.device, torch.int64), minlength=self.c)
        sums = torch.empty((self.c, self.d), dtype=torch.int64, device=self.device)
        idx = self.table.to(torch.int64)
        for c in range(self.c):
            ge = torch.gather(at_least[c], 1, idx)  # (H, D)
            sums[c] = 2 * ge.sum(0) - self.h * n_c[c]
        return sums

    def centred_bits(self, hv: torch.Tensor) -> torch.Tensor:
        """Row centring then sign: ``float32(hv) - float32(rowsum) *
        float32(1 / D) >= 0`` with the row sum exact in int64."""
        inv = torch.tensor(float(_F32(1.0) / _F32(self.d)), dtype=torch.float32,
                           device=hv.device)
        mean = hv.to(torch.int64).sum(-1, keepdim=True).to(torch.float32) * inv
        return (hv.to(torch.float32) - mean) >= 0

    def labels(self, images: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
        """Nearest class by Hamming distance of the centred sign bits,
        lowest class index on ties."""
        cb = self.centred_bits(sums)
        qb = self.centred_bits(self.encode(images))
        dist = (qb[:, None, :] != cb[None, :, :]).sum(-1)
        return torch.argmin(dist, dim=1).to(torch.int32)  # first minimum


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, d) bool -> (N, ceil(d / 32)) int32 words (the bit patterns of
    uint32 words), bit j of word w holding dimension 32 w + j, pad bits 0."""
    n, d = bits.shape
    w = -(-d // 32)
    padded = torch.zeros((n, w * 32), dtype=torch.int64, device=bits.device)
    padded[:, :d] = bits.to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << torch.arange(
        32, dtype=torch.int64, device=bits.device)
    u = (padded.view(n, w, 32) * weights).sum(-1)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def unpack_words(words: torch.Tensor, d: int) -> torch.Tensor:
    """(N, W) int32 words, 32 dimensions a word, bit j of word w is
    dimension 32 w + j -> (N, d) bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :d].bool()


def topk_pinned(query_bits: torch.Tensor, store_words: np.ndarray | torch.Tensor, d: int,
                k: int, device: torch.device | str, block: int = 32768
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest store rows of each query by Hamming distance,
    ascending by (distance, row): ((B, k) int32 rows, (B, k) int32
    distances).  Distances come from a float32 product of the ±1 forms,
    exact as every partial sum is an integer below 2**24."""
    dev = torch.device(device)
    q = query_bits.to(dev).to(torch.float32) * 2 - 1
    with exact_float32():
        best = _scan(q, store_words, d, k, dev, block)
    best = torch.sort(best, dim=1).values
    return (best & 0xFFFFFFFF).to(torch.int32), (best >> 32).to(torch.int32)


def _scan(q, store_words, d, k, dev, block):
    """(B, k) int64 keys distance * 2**32 + row, the k smallest per query."""
    best = None
    for i in range(0, store_words.shape[0], block):
        rows = torch.as_tensor(store_words[i:i + block]).to(dev)
        s = unpack_words(rows, d).to(torch.float32) * 2 - 1
        dist = ((d - q @ s.T) / 2).round().to(torch.int64)
        key = dist * (1 << 32) + torch.arange(i, i + rows.shape[0], device=dev)
        cand = torch.topk(key, min(k, rows.shape[0]), dim=1, largest=False).values
        best = cand if best is None else torch.topk(
            torch.cat([best, cand], 1), k, dim=1, largest=False).values
    return best
