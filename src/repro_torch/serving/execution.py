"""Execution backends: where a packed-predict engine runs.

The torch counterpart of ``repro.serving.execution``, single-device
part: :class:`DeviceExecution` (and :func:`resolve_impl`, which lives in
``core.registry``).  The D-sharded ``ShardedExecution`` and
``plan_executions`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.core.hdc_model import HDCModel, predict_packed, resolve_device, search_packed
from repro_torch.core.registry import resolve_impl

__all__ = ["DeviceExecution", "resolve_impl"]


class DeviceExecution:
    """Single-device placement: the model and every request on one device.
    The datapath follows the device: the kernels on a card, the plain
    versions on the CPU."""

    placement = "device"

    def __init__(self, *, device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.impl = resolve_impl("auto", self.device.type)

    def place(self, model: HDCModel) -> HDCModel:
        return model.to_device(self.device)

    def pack(self, model: HDCModel) -> torch.Tensor:
        return model.pack()

    def predict(self, model: HDCModel, class_words: torch.Tensor, images) -> torch.Tensor:
        return predict_packed(model, images, class_words)

    def search(
        self, model: HDCModel, class_words: torch.Tensor, images, k: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The k nearest packed rows per query, ascending (distance, index)."""
        return search_packed(model, images, class_words, k=k)

    def describe(self) -> dict:
        return {"placement": self.placement, "impl": self.impl, "device": str(self.device)}
