"""Blocks of colour images through the classify path (``classify``): rows
of ``channels`` planes of ``side`` x ``side`` pixels, channel-major (the
whole first plane, then the second, ...), as CIFAR's binary files store
them, judged by the reference past 1,110 features (``bench.reference.wide``).

Parameters: ``classify``'s, and ``channels``, ``side`` and ``k`` (1: a
label is the nearest class), which must agree with the configuration.
"""

from __future__ import annotations

import torch

from bench.entries.classify import Classify
from bench.images import StrokeImages
from bench.reference import wide


class ColourStrokeImages(StrokeImages):
    """Stroke images in colour: each class also draws a colour, a weight a
    channel from U(*``tint``), and an image is its grey strokes
    (``StrokeImages``) times its class's colour, plus |N(0, 1)| *
    ``channel_noise_std`` drawn for each channel, clipped to [0, 255]."""

    def __init__(self, spec: dict, seed: int, device: torch.device | str):
        super().__init__(spec, seed, device)
        self.channels = int(spec["channels"])
        self.channel_noise = float(spec["channel_noise_std"])
        lo, hi = (float(v) for v in spec["tint"])
        self.tint = lo + (hi - lo) * self._rand(self.n_classes, self.channels)

    def draw(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """((n, channels * side * side) float32 images in [0, 255],
        channel-major, (n,) int32 labels)."""
        grey, labels = super().draw(n)
        img = grey[:, None, :] * self.tint[labels.to(torch.int64)][:, :, None]
        img = img + self._randn(n, self.channels, grey.shape[1]).abs() * self.channel_noise
        return torch.clamp(img, 0, 255).reshape(n, -1), labels


class ClassifyRGB(Classify):
    def setup(self) -> None:
        spec, t = self.cell.config["images"], self.t
        c, s = int(t["channels"]), int(t["side"])
        if (c, s) != (int(spec["channels"]), int(spec["side"])) or c * s * s != self.shape()[0]:
            raise ValueError(f"traffic of {c} x {s} x {s} pixels does not fit the configuration")
        if int(t["k"]) != 1:
            raise ValueError("the classify path answers the nearest class: k = 1")
        super().setup()

    def stroke_images(self) -> ColourStrokeImages:
        return ColourStrokeImages(self.cell.config["images"], self.seed, self.device)

    def reference(self, image_dtype=torch.float32) -> wide.Reference:
        return wide.Reference(self.hdc, self.device, image_dtype)


ENTRY = ClassifyRGB
