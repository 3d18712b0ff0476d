"""Meshes of devices and the D-axis sharding rules of the HDC state.

The torch counterpart of the HDC part of ``repro.distributed.sharding``
(``ShardingRules``, ``model_mesh``, ``model_axis_for``, the current
mesh); the parameter rules of the LM scaffolding are not ported.

The JAX package runs its sharded paths under one controller: one
process drives every device of a ``jax.sharding.Mesh`` through
``shard_map``, and a ``psum`` is the only step between devices.  The
port keeps that shape.  A :class:`Mesh` is a numpy object grid of
``torch.device``s with axis names; one process drives every cell, and
the sum of the per-shard int32 partials on the output device takes the
place of the ``psum`` (exact in any order).  A device may appear more
than once: a mesh that names ``"cpu"`` eight times runs eight shards one
after another on the CPU, as the JAX tests' forced host devices do, and
a mesh that names ``cuda:0`` four times does the same on one card.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

_CURRENT_MESH: list["Mesh | None"] = [None]


def _device(dev) -> torch.device:
    """A mesh cell's device: ``cuda`` gets the current card's index, so
    that equal devices compare equal; a CUDA device without a card raises."""
    from repro_torch.core.hdc_model import resolve_device

    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An n-dimensional grid of devices with one name per axis (the
    counterpart of ``jax.sharding.Mesh``).  All devices are of one type,
    ``cuda`` or ``cpu``."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(
                f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, got {axis_names}"
            )
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ, got {axis_names}")
        cells = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            cells[idx] = _device(grid[idx])
        types = {d.type for d in cells.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")
        self.devices = cells
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def platform(self) -> str:
        """``"cuda"`` or ``"cpu"``: the registry's platform of every cell."""
        return self.devices.flat[0].type

    def device_at(self, index: dict[str, int]) -> torch.device:
        """The device at the given axis positions (0 on axes not named)."""
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]

    def _key(self):
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def set_current_mesh(mesh: Mesh | None) -> None:
    _CURRENT_MESH[0] = mesh


def get_current_mesh() -> Mesh | None:
    return _CURRENT_MESH[0]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mesh axis names: the tensor-model axis splits the trailing D of the
    HDC state; the batch axes (``pod``, ``data``, those present) split
    training batches."""

    model_axis: str = "model"
    data_axis: str = "data"
    pod_axis: str = "pod"

    def batch_axes(self, mesh: Mesh) -> tuple[str, ...]:
        return tuple(a for a in (self.pod_axis, self.data_axis) if a in mesh.axis_names)

    def batch_groups(self, mesh: Mesh) -> list[dict[str, int]]:
        """Positions on the batch axes, one per batch shard, in the JAX
        package's order (the first batch axis the slowest)."""
        axes = self.batch_axes(mesh)
        shape = mesh.shape
        return [dict(zip(axes, idx)) for idx in itertools.product(*(range(shape[a]) for a in axes))]


def local_devices() -> list[torch.device]:
    """Every visible card; raises without one (pass devices explicitly,
    e.g. ``["cpu"]``, to run the plain datapath on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA devices by default and none is available; "
            "pass devices=['cpu'] (or device='cpu') to run the plain PyTorch "
            "datapath on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def model_mesh(devices=None, *, rules: ShardingRules | None = None) -> Mesh:
    """One-axis tensor-model mesh over explicit devices (default: every
    visible card), the serving-side mesh of a replica's device group."""
    rules = rules or ShardingRules()
    devs = list(devices) if devices is not None else local_devices()
    if not devs:
        raise ValueError("model_mesh: empty device list")
    return Mesh(devs, (rules.model_axis,))


def model_axis_for(mesh: Mesh, dim: int, *, rules: ShardingRules | None = None) -> str | None:
    """The tensor-model mesh axis usable for a trailing dimension of size
    `dim`, or None when it is absent or does not divide: the one decision
    point of the D-partitioning of state, slices and generator offsets."""
    rules = rules or ShardingRules()
    axis = rules.model_axis if rules.model_axis in mesh.axis_names else None
    if axis and dim % mesh.shape[axis] == 0 and dim >= mesh.shape[axis]:
        return axis
    return None
