"""Item memory: a mutable store of packed hypervectors with scored
nearest-neighbour search (DESIGN.md §14).

The torch counterpart of ``repro.core.item_memory``.  Rows are binarized
hypervectors packed 32 dimensions a word (~1 KB each at D = 8192), kept
on the host as one contiguous array of int32 bit patterns (the JAX
package's uint32 words, bit for bit).  ``search`` moves them to the
memory's device lazily and keeps that copy until the next mutation, so
the steady-state cost of a query batch is one packed scan through
``kernels.ops.hamming_topk``: the CUDA kernel on a card, the plain
version on the CPU.

Indices returned by ``search`` are *current positions* in the store:
``delete`` compacts, so positions shift left past the deleted rows (the
usual numpy-delete semantics).  Callers needing stable external ids keep
their own id column alongside.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import unary
from repro_torch.core.hdc_model import resolve_device
from repro_torch.obs.profiler import span


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


class ItemMemory:
    """Append/delete/search over packed ±1 hypervector rows.

    ``d`` is the hypervector dimensionality (need not be a multiple of
    32; pad bits are zeroed by the packers and cancel in the XOR).  The
    scan runs on ``device`` (``None`` means ``"cuda"``; without a card
    that raises unless ``device="cpu"``).
    """

    def __init__(self, d: int, *, device: torch.device | str | None = None):
        if d < 1:
            raise ValueError(f"d must be positive, got {d}")
        self.d = int(d)
        self.n_words = unary.n_words(self.d)
        self.device = resolve_device(device)
        self._rows = np.zeros((0, self.n_words), np.int32)
        self._dev: torch.Tensor | None = None  # device copy of _rows

    def __len__(self) -> int:
        return self._rows.shape[0]

    @property
    def nbytes(self) -> int:
        return self._rows.nbytes

    def add(self, hvs) -> np.ndarray:
        """Append ±1 (or sign-of-sum) hypervectors; (n, d) -> the n new
        row positions.  Sign-packs exactly like `HDCModel.pack`: bit =
        (hv >= 0), pad bits zero."""
        hvs = _as_tensor(hvs).cpu()
        if hvs.dim() == 1:
            hvs = hvs[None]
        if hvs.shape[-1] != self.d:
            raise ValueError(f"expected hypervectors of d={self.d}, got {hvs.shape[-1]}")
        return self.add_packed(unary.pack_hypervector(hvs).numpy())

    def add_packed(self, words) -> np.ndarray:
        """Append already-packed rows, (n, n_words) uint32 words (or their
        int32 bit patterns) -> the n new row positions."""
        if isinstance(words, torch.Tensor):
            words = words.cpu().numpy()
        words = np.asarray(words)
        if words.dtype != np.int32:
            words = words.astype(np.uint32).view(np.int32)
        if words.ndim == 1:
            words = words[None]
        if words.shape[-1] != self.n_words:
            raise ValueError(f"expected {self.n_words} words per row, got {words.shape[-1]}")
        start = len(self)
        self._rows = np.concatenate([self._rows, words], axis=0)
        self._dev = None
        return np.arange(start, len(self), dtype=np.int32)

    def delete(self, indices) -> None:
        """Remove rows by current position; later rows shift left."""
        idx = np.atleast_1d(np.asarray(indices, np.int64))
        n = len(self)
        if idx.size and (idx.min() < -n or idx.max() >= n):
            raise IndexError(f"row index out of range for store of {n}")
        self._rows = np.delete(self._rows, idx, axis=0)
        self._dev = None

    def _device_rows(self) -> torch.Tensor:
        if self._dev is None:
            self._dev = torch.from_numpy(self._rows).to(self.device)
        return self._dev

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """k nearest stored rows per query, pinned lowest-index ties.

        ``queries`` is either (B, d) raw ±1 hypervectors (sign-packed
        here) or (B, n_words) uint32 already-packed rows.  Returns
        ((B, k) int32 positions, (B, k) int32 Hamming distances), each
        row ascending by (distance, index).
        """
        from repro_torch.kernels import ops

        k = int(k)
        if not 1 <= k <= len(self):
            raise ValueError(
                f"k must be in [1, {len(self)}] for a store of {len(self)} rows, got {k}"
            )
        if isinstance(queries, np.ndarray) and queries.dtype == np.uint32:
            queries = queries.view(np.int32)
            packed = True
        else:
            packed = isinstance(queries, torch.Tensor) and queries.dtype == torch.uint32
            if packed:
                queries = queries.view(torch.int32)
        with span("store.copy_in"):
            q = _as_tensor(queries).to(self.device)
            if q.dim() == 1:
                q = q[None]
            if packed and q.shape[-1] == self.n_words:
                qw = q
            elif not packed and q.shape[-1] == self.d:
                qw = unary.pack_hypervector(q)
            else:
                raise ValueError(
                    f"queries must be (B, {self.d}) hypervectors or (B, {self.n_words}) packed "
                    f"uint32 rows, got {tuple(q.shape)}"
                )
        with span("store.rows"):
            rows = self._device_rows()
        with span("store.scan"):
            idx, dist = ops.hamming_topk(qw.contiguous(), rows, self.d, k)
        with span("store.wait"):
            return idx.cpu().numpy(), dist.cpu().numpy()
