"""`ServingEngine`: the pack-once packed-Hamming inference unit.

The torch counterpart of ``repro.serving.engine``.  At load the engine
restores an `HDCModel`, places it per its execution backend (one
device, or D-sharded over a mesh: :mod:`repro_torch.serving.execution`),
and binarizes and packs the (C, D) class sums into words once, in the
backend's layout; after that every request batch is encode -> pack ->
XOR + popcount -> nearest class.  Engines are immutable: a reload builds
a new engine from a newer step.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from repro_torch.core.hdc_model import HDCModel
from repro_torch.serving.execution import DeviceExecution, ShardedExecution, resolve_impl

__all__ = ["ServingEngine", "resolve_impl"]


class ServingEngine:
    """One loaded model, packed for inference, on one device or a mesh."""

    def __init__(
        self,
        model: HDCModel,
        *,
        batch_size: int = 64,
        step: int | None = None,
        source: str | Path | None = None,
        execution: DeviceExecution | ShardedExecution | None = None,
        device: torch.device | str | None = None,
    ):
        self.execution = execution or DeviceExecution(device=device)
        self.model = self.execution.place(model)
        self.batch_size = int(batch_size)
        self.impl = self.execution.impl
        self.step = step
        self.source = Path(source) if source is not None else None
        # pack ONCE at load: per-request work never touches the class sums
        self.class_words = self.execution.pack(self.model)

    @classmethod
    def from_checkpoint(
        cls,
        path: str | Path,
        *,
        step: int | None = None,
        batch_size: int = 64,
        execution: DeviceExecution | ShardedExecution | None = None,
        device: torch.device | str | None = None,
    ) -> "ServingEngine":
        """Load a checkpointed `HDCModel` (latest step by default; gathered
        or per-host shards), place it per `execution` and pack it."""
        from repro_torch.checkpoint.manager import CheckpointManager

        execution = execution or DeviceExecution(device=device)
        if step is None:
            step = CheckpointManager(path).latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
        model = execution.load(path, step)
        return cls(model, batch_size=batch_size, step=step, source=path, execution=execution)

    # -- inference --------------------------------------------------------

    def predict(self, images) -> np.ndarray:
        """(B, H) raw images -> (B,) int32 labels (host numpy)."""
        labels = self.execution.predict(self.model, self.class_words, images)
        return labels.cpu().numpy()

    def search(self, images, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(B, H) raw images -> ((B, k) int32 row indices, (B, k) int32
        Hamming distances), ascending by (distance, index); ``k=1``
        indices equal `predict`'s labels."""
        idx, dist = self.execution.search(self.model, self.class_words, images, int(k))
        return idx.cpu().numpy(), dist.cpu().numpy()

    def warmup(self) -> "ServingEngine":
        """Run one static-shape batch (builds the kernels on a card)."""
        dummy = torch.zeros(
            (self.batch_size, self.model.cfg.n_features), dtype=torch.float32,
            device=self.model.device,
        )
        self.execution.predict(self.model, self.class_words, dummy)
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        return self

    def describe(self) -> dict:
        cfg = self.model.cfg
        words = self.class_words
        words = words if isinstance(words, list) else [words]
        return {
            "encoder": cfg.encoder,
            "d": cfg.d,
            "n_classes": cfg.n_classes,
            "impl": self.impl,
            "placement": self.execution.placement,
            "execution": self.execution.describe(),
            "batch_size": self.batch_size,
            "step": self.step,
            "source": str(self.source) if self.source else None,
            "n_seen": self.model.n_examples,
            "packed_bytes": 4 * sum(w.numel() for w in words),
            "codebook_bytes": int(self.model.codebook_bytes),
        }
