"""Image datasets for the HDC experiments (numpy).

A copy of ``repro.data.images`` (the port imports nothing of the JAX
package); the crc32 seeding keeps the synthetic sets byte-identical to
the JAX package's.

Real datasets (MNIST et al.) are loaded from ``$REPRO_DATA_DIR`` when the
IDX/NPZ files exist; otherwise the default is
a family of *structured synthetic* datasets: per-class smooth prototypes
(low-frequency random fields) + per-sample spatial jitter + pixel noise.
They reproduce the qualitative phenomena the paper measures (accuracy
grows with D; deterministic Sobol encoding beats the average
pseudo-random draw) with fully deterministic generation.

The port adds one set the JAX package lacks: ``cifar100`` (CIFAR-100's
binary files, ``cifar-100-binary/{train,test}.bin``), whose fallback is a
three-channel synthetic analogue of its shape (:func:`make_synthetic_cifar100`),
kept out of ``_SYNTH_SPECS`` so that :data:`ALL_SYNTHETIC` and every set
in it stay the JAX package's.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
import zlib
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    name: str
    train_images: np.ndarray  # (N, H) float32 in [0, 255]
    train_labels: np.ndarray  # (N,) int32
    test_images: np.ndarray
    test_labels: np.ndarray
    image_shape: tuple[int, ...]  # (side, side), or (channels, side, side) channel-major
    n_classes: int
    synthetic: bool

    @property
    def n_features(self) -> int:
        return int(np.prod(self.image_shape))


# ---------------------------------------------------------------------------
# Synthetic structured datasets
# ---------------------------------------------------------------------------

# name -> (side, n_classes, n_strokes, noise_std, jitter_px, anchor_jitter)
# Stroke-based sparse images (bright strokes on dark background) — the
# statistics regime of MNIST-family data that HDC encoders are built for.
_SYNTH_SPECS: dict[str, tuple[int, int, int, float, int, float]] = {
    "synth_mnist": (28, 10, 4, 24.0, 2, 1.2),
    "synth_fashion": (28, 10, 6, 32.0, 2, 1.5),
    "synth_cifar10": (32, 10, 8, 56.0, 3, 2.2),
    "synth_svhn": (32, 10, 5, 44.0, 3, 1.8),
    "synth_blood": (28, 8, 5, 30.0, 2, 1.5),
    "synth_breast": (28, 2, 6, 40.0, 2, 2.0),
}


def _draw_strokes(side: int, anchors: np.ndarray) -> np.ndarray:
    """Render poly-line strokes (anchors (k, 2)) onto a (side, side) canvas."""
    img = np.zeros((side, side), dtype=np.float32)
    for a, b in zip(anchors[:-1], anchors[1:]):
        n = int(np.hypot(*(b - a)) * 2) + 2
        ts = np.linspace(0.0, 1.0, n)[:, None]
        pts = a[None, :] * (1 - ts) + b[None, :] * ts
        ij = np.clip(np.round(pts).astype(int), 0, side - 1)
        img[ij[:, 0], ij[:, 1]] = 255.0
    # 3x3 box blur to thicken strokes (MNIST-like anti-aliasing)
    pad = np.pad(img, 1)
    img = sum(
        pad[di : di + side, dj : dj + side] for di in range(3) for dj in range(3)
    ) / 5.0
    return np.clip(img, 0, 255)


def _jitter(rng: np.random.Generator, img: np.ndarray, max_px: int) -> np.ndarray:
    dx, dy = rng.integers(-max_px, max_px + 1, size=2)
    return np.roll(np.roll(img, dx, axis=0), dy, axis=1)


#: the three-channel analogue of CIFAR-100 (32 x 32 x 3, 100 fine classes):
#: synth_cifar10's strokes, over 100 prototypes; not in _SYNTH_SPECS, so
#: ALL_SYNTHETIC is the JAX package's
_SYNTH_CIFAR100 = ("synth_cifar100", (32, 100, 8, 56.0, 3, 2.2))
#: each class's colour, a weight a channel drawn from U(*_TINT)
_TINT = (0.25, 1.0)


def make_synthetic(
    name: str, n_train: int = 4096, n_test: int = 1024, seed: int = 0
) -> ImageDataset:
    return _synthetic(name, _SYNTH_SPECS[name], n_train, n_test, seed)


def make_synthetic_cifar100(n_train: int = 4096, n_test: int = 1024,
                            seed: int = 0) -> ImageDataset:
    """CIFAR-100's shape when its files are absent: each class a stroke
    prototype and a colour (a weight a channel in [0.25, 1)), each image
    its class's grey strokes times that colour, with noise drawn for each
    channel; rows channel-major (1,024 red, 1,024 green, 1,024 blue), as
    CIFAR's binary files store them."""
    return _synthetic(*_SYNTH_CIFAR100, n_train, n_test, seed, channels=3)


def _synthetic(name: str, spec: tuple, n_train: int, n_test: int, seed: int,
               channels: int = 1) -> ImageDataset:
    side, n_classes, n_str, noise, jit, aj = spec
    # zlib.crc32, not hash(): str hashes are randomized per process, and
    # the dataset must be reproducible across runs (a checkpointed model
    # evaluated in a new process has to see the same test split).
    name_key = zlib.crc32(name.encode()) & 0x7FFFFFFF
    rng = np.random.default_rng(np.random.SeedSequence([name_key, seed]))
    # class prototype = a fixed set of stroke anchor points
    protos = [
        rng.uniform(3, side - 3, size=(n_str + 1, 2)).astype(np.float32)
        for _ in range(n_classes)
    ]
    tint = rng.uniform(*_TINT, size=(n_classes, channels, 1, 1)) if channels > 1 else None

    def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, n_classes, size=n).astype(np.int32)
        imgs = np.empty((n, channels * side * side), dtype=np.float32)
        for i, c in enumerate(labels):
            anchors = protos[c] + rng.standard_normal(protos[c].shape) * aj
            img = _draw_strokes(side, anchors)
            img = img * rng.uniform(0.75, 1.0)  # stroke intensity variation
            img = _jitter(rng, img, jit)
            if tint is not None:
                img = img[None] * tint[c]  # (channels, side, side)
            img = img + np.abs(rng.standard_normal(img.shape)) * noise
            imgs[i] = np.clip(img, 0, 255).reshape(-1)
        return imgs, labels

    tr_x, tr_y = sample(n_train)
    te_x, te_y = sample(n_test)
    shape = (side, side) if channels == 1 else (channels, side, side)
    return ImageDataset(name, tr_x, tr_y, te_x, te_y, shape, n_classes, True)


# ---------------------------------------------------------------------------
# Real data loaders (IDX / NPZ), used when files are present
# ---------------------------------------------------------------------------


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _try_load_mnist(root: Path) -> ImageDataset | None:
    names = {
        "train_images": ["train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"],
        "train_labels": ["train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz"],
        "test_images": ["t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz"],
        "test_labels": ["t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz"],
    }
    found: dict[str, Path] = {}
    for key, cands in names.items():
        for c in cands:
            p = root / "mnist" / c
            if p.exists():
                found[key] = p
                break
        else:
            return None
    tr_x = _read_idx(found["train_images"]).reshape(-1, 784).astype(np.float32)
    te_x = _read_idx(found["test_images"]).reshape(-1, 784).astype(np.float32)
    tr_y = _read_idx(found["train_labels"]).astype(np.int32)
    te_y = _read_idx(found["test_labels"]).astype(np.int32)
    return ImageDataset("mnist", tr_x, tr_y, te_x, te_y, (28, 28), 10, False)


def _try_load_cifar100(root: Path) -> ImageDataset | None:
    """CIFAR-100's binary version: rows of 3,074 bytes, the coarse label,
    the fine label (the class), then 3,072 pixels channel-major."""
    paths = [root / "cifar-100-binary" / f"{split}.bin" for split in ("train", "test")]
    if not all(p.exists() for p in paths):
        return None
    parts = []
    for p in paths:
        rows = np.fromfile(p, dtype=np.uint8)
        if rows.size % 3074:
            raise ValueError(f"{p}: {rows.size} bytes is not a whole number of 3,074-byte rows")
        rows = rows.reshape(-1, 3074)
        parts += [rows[:, 2:].astype(np.float32), rows[:, 1].astype(np.int32)]
    return ImageDataset("cifar100", *parts, (3, 32, 32), 100, False)


def load_dataset(
    name: str, n_train: int = 4096, n_test: int = 1024, seed: int = 0
) -> ImageDataset:
    """Load `name`; real data if available under $REPRO_DATA_DIR, else the
    synthetic analogue (``mnist`` falls back to ``synth_mnist``,
    ``cifar100`` to ``synth_cifar100`` etc.)."""
    root = Path(os.environ.get("REPRO_DATA_DIR", "/data"))
    if name == "mnist":
        ds = _try_load_mnist(root)
        if ds is not None:
            return ds
        name = "synth_mnist"
    if name == "cifar100":
        ds = _try_load_cifar100(root)
        if ds is not None:
            return ds
        name = _SYNTH_CIFAR100[0]
    if name == _SYNTH_CIFAR100[0]:
        return make_synthetic_cifar100(n_train, n_test, seed)
    if name in _SYNTH_SPECS:
        return make_synthetic(name, n_train, n_test, seed)
    raise ValueError(f"unknown dataset {name!r}")


ALL_SYNTHETIC = tuple(_SYNTH_SPECS)
