"""Mesh construction: the production meshes and the elastic factory (the
torch counterpart of ``repro.launch.mesh``).  Building a mesh reads the
visible cards; importing this module touches no device."""

from __future__ import annotations

import numpy as np

from repro_torch.distributed.sharding import Mesh, local_devices


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The assignment's production mesh.

    Single pod: (16, 16) = 256 devices, axes ("data", "model").
    Multi-pod:  (2, 16, 16) = 512 devices, axes ("pod", "data", "model").
    ``devices`` defaults to every visible card; the grid takes the first
    256 (512) of them, and fewer raise, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = list(devices) if devices is not None else local_devices()
    n = int(np.prod(shape))
    if len(devs) < n:
        raise ValueError(f"the production mesh {shape} needs {n} devices, {len(devs)} given")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(shape), axes)


def mesh_for(n_devices: int | None = None, model_parallel: int = 16, *, devices=None) -> Mesh:
    """Largest ``(data, model)`` grid for the devices present: the model
    axis is the largest power-of-two divisor of the device count up to
    `model_parallel`, the data axis the rest.  ``devices`` defaults to
    every visible card; the grid takes the first `n_devices` of them."""
    devs = list(devices) if devices is not None else local_devices()
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise ValueError(f"mesh_for: {n} devices asked, {len(devs)} given")
    model = model_parallel
    while model > 1 and (n % model or (n // model) < 1):
        model //= 2
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(n // model, model), ("data", "model"))


def describe(mesh: Mesh) -> str:
    return f"mesh{mesh.shape} on {mesh.size} devices"
