"""Stroke images made on the device from the seed, in bulk.

The statistics are those of the port's ``synth_mnist`` set (28 x 28, ten
classes, a class prototype of five anchors uniform in [3, side - 3),
anchors jittered by N(0, 1.2), poly-line strokes sampled at
``int(2 * length) + 2`` points and set to 255, a 3 x 3 box sum / 5,
intensity x U(0.75, 1), a roll of up to 2 pixels each way, and
|N(0, 1)| * 24 of noise, clipped to [0, 255]), drawn for a whole chunk
of images at once with one ``torch.Generator`` on the device instead of
one image at a time in Python.  The same seed on the same device gives
the same images.
"""

from __future__ import annotations

import torch

#: points a stroke segment is sampled at, at most (2 * length + 2 with
#: length < 2 * side, and the extra points repeat the segment's end)
_MAX_POINTS = 128


class StrokeImages:
    """A stream of labelled stroke images from one seed."""

    def __init__(self, spec: dict, seed: int, device: torch.device | str):
        self.side = int(spec["side"])
        self.n_classes = int(spec["n_classes"])
        self.n_anchors = int(spec["n_strokes"]) + 1
        self.noise = float(spec["noise_std"])
        self.jitter = int(spec["jitter_px"])
        self.anchor_jitter = float(spec["anchor_jitter"])
        self.intensity = tuple(float(v) for v in spec["intensity"])
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (1 << 64))
        lo, hi = 3.0, float(self.side - 3)
        self.protos = lo + (hi - lo) * self._rand(self.n_classes, self.n_anchors, 2)

    def _rand(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _randn(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def draw(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """((n, side * side) float32 images in [0, 255], (n,) int32 labels)."""
        s, dev = self.side, self.device
        labels = torch.randint(0, self.n_classes, (n,), generator=self.gen, device=dev)
        anchors = self.protos[labels] + self._randn(n, self.n_anchors, 2) * self.anchor_jitter
        a, b = anchors[:, :-1], anchors[:, 1:]  # (n, strokes, 2)
        length = torch.linalg.vector_norm(b - a, dim=-1)
        points = (length * 2).to(torch.int64) + 2  # (n, strokes)
        j = torch.arange(_MAX_POINTS, device=dev, dtype=torch.float32)
        t = torch.clamp(j / (points[..., None] - 1).to(torch.float32), max=1.0)
        pts = a[..., None, :] * (1 - t[..., None]) + b[..., None, :] * t[..., None]
        ij = torch.clamp(torch.round(pts).to(torch.int64), 0, s - 1)
        row = torch.arange(n, device=dev)[:, None, None]
        flat = (row * s + ij[..., 0]) * s + ij[..., 1]
        canvas = torch.zeros(n * s * s, dtype=torch.float32, device=dev)
        canvas[flat.reshape(-1)] = 255.0
        canvas = canvas.view(n, s, s)
        pad = torch.nn.functional.pad(canvas, (1, 1, 1, 1))
        img = sum(pad[:, di:di + s, dj:dj + s] for di in range(3) for dj in range(3)) / 5.0
        img = torch.clamp(img, 0, 255)
        lo, hi = self.intensity
        img = img * (lo + (hi - lo) * self._rand(n, 1, 1))
        shift = torch.randint(-self.jitter, self.jitter + 1, (n, 2), generator=self.gen,
                              device=dev)
        k = torch.arange(s, device=dev)
        ri = (k[None, :] - shift[:, :1]) % s  # rolled row i reads row i - dx
        ci = (k[None, :] - shift[:, 1:]) % s
        img = img[row[:, :, 0, None], ri[:, :, None], ci[:, None, :]]
        img = img + self._randn(n, s, s).abs() * self.noise
        return torch.clamp(img, 0, 255).reshape(n, s * s), labels.to(torch.int32)

    def draw_chunks(self, n: int, chunk: int = 65536):
        """`n` images as successive chunks of at most `chunk`."""
        for i in range(0, n, chunk):
            yield self.draw(min(chunk, n - i))
