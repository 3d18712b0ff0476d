"""Mesh construction: the production meshes and the elastic factory (the
torch counterpart of ``repro.launch.mesh``).  Building a mesh reads the
visible cards; importing this module touches no device.

JAX drives every device from one process.  The port's LM launchers run
one process a card under ``python -m torch.distributed.run``
(PyTorch's idiom, and what ``DTensor`` needs): :func:`init_distributed`
starts the process group from torchrun's environment, and while a group
is up :func:`mesh_for` and :func:`make_production_mesh` take the group's
ranks as their devices, in the same shapes, so the mesh places tensors
as ``DTensor``s (``distributed.sharding``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh, local_devices


def group_up() -> bool:
    """Whether a default process group is initialised."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def init_distributed(device=None) -> torch.device | None:
    """Start the default process group from torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` (and ``MASTER_ADDR``/``MASTER_PORT``)
    and return this process's device: ``cuda:<LOCAL_RANK>`` over NCCL, or
    the CPU over gloo when `device` is the CPU.  Outside torchrun (no
    ``WORLD_SIZE``) it starts nothing and returns None; a group already up
    is kept."""
    if "WORLD_SIZE" not in os.environ:
        return None
    import torch.distributed as dist

    from repro_torch.core.hdc_model import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not group_up():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
            **({"device_id": dev} if dev.type == "cuda" else {}),
        )
    return dev


def group_devices() -> tuple[list[torch.device], list[int]]:
    """Every rank of the group with its device: ``cuda:<rank mod
    LOCAL_WORLD_SIZE>`` on NCCL, the CPU on gloo."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if dist.get_backend() == "nccl":
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", torch.cuda.device_count()))
        return [torch.device("cuda", r % per_host) for r in range(n)], list(range(n))
    return [torch.device("cpu")] * n, list(range(n))


def _grid(devs: list, shape: tuple[int, ...]) -> np.ndarray:
    n = int(np.prod(shape))
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The assignment's production mesh.

    Single pod: (16, 16) = 256 devices, axes ("data", "model").
    Multi-pod:  (2, 16, 16) = 512 devices, axes ("pod", "data", "model").
    ``devices`` defaults to the group's ranks while a group is up, else to
    every visible card; the grid takes the first 256 (512) of them, and
    fewer raise, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = None
    if devices is None and group_up():
        devs, ranks = group_devices()
    else:
        devs = list(devices) if devices is not None else local_devices()
    n = int(np.prod(shape))
    if len(devs) < n:
        raise ValueError(f"the production mesh {shape} needs {n} devices, {len(devs)} given")
    return Mesh(_grid(devs, shape), axes,
                ranks=None if ranks is None else np.asarray(ranks[:n]).reshape(shape))


def mesh_for(n_devices: int | None = None, model_parallel: int = 16, *, devices=None) -> Mesh:
    """Largest ``(data, model)`` grid for the devices present: the model
    axis is the largest power-of-two divisor of the device count up to
    `model_parallel`, the data axis the rest.  ``devices`` defaults to
    the group's ranks while a group is up (one process a card), else to
    every visible card; the grid takes the first `n_devices` of them."""
    ranks = None
    if devices is None and group_up():
        devs, ranks = group_devices()
    else:
        devs = list(devices) if devices is not None else local_devices()
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise ValueError(f"mesh_for: {n} devices asked, {len(devs)} given")
    model = model_parallel
    while model > 1 and (n % model or (n // model) < 1):
        model //= 2
    shape = (n // model, model)
    return Mesh(_grid(devs, shape), ("data", "model"),
                ranks=None if ranks is None else np.asarray(ranks[:n]).reshape(shape))


def describe(mesh: Mesh) -> str:
    procs = f" ({mesh.size} processes)" if mesh.distributed else ""
    return f"mesh{mesh.shape} on {mesh.size} devices{procs}"
