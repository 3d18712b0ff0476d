"""Meshes of devices and the sharding rules.

The torch counterpart of ``repro.distributed.sharding``: the D-axis
rules of the HDC state (``ShardingRules.batch_axes``, ``model_mesh``,
``model_axis_for``, the current mesh), and the LM path's logical-axis
rules (``TP_LOGICAL``, ``ShardingRules.param_spec`` and
``activation_spec``, ``tree_param_shardings``, ``abstract_params``) with
its ``constrain`` and ``constrain_batch``.

A spec is a :class:`PartitionSpec`, a tuple with one entry a dimension
(None, a mesh axis name, or a tuple of them), equal entry for entry to
JAX's for the same shape, axes and mesh.

Two ways to run over a mesh, one for each family of paths:

* The HDC paths keep the JAX package's single controller: one process
  drives every device of a ``jax.sharding.Mesh`` through ``shard_map``,
  and a ``psum`` is the only step between devices.  A :class:`Mesh` is a
  numpy object grid of ``torch.device``s with axis names; one process
  drives every cell, and the sum of the per-shard int32 partials on the
  output device takes the place of the ``psum`` (exact in any order).  A
  device may appear more than once: a mesh that names ``"cpu"`` eight
  times runs eight shards one after another on the CPU, as the JAX
  tests' forced host devices do, and a mesh that names ``cuda:0`` four
  times does the same on one card.
* The LM paths run one process a card, PyTorch's idiom, under
  ``python -m torch.distributed.run`` (``launch.mesh.init_distributed``
  starts the group: NCCL on ``cuda:<LOCAL_RANK>``, gloo on the CPU).
  A mesh built there (``launch.mesh.mesh_for``) also holds the group's
  ranks, and :meth:`Mesh.device_mesh` gives the ``DeviceMesh`` of the
  same shape and axis names.  A :class:`NamedSharding` on such a mesh
  places a tensor as a ``DTensor`` whose placements come from its spec
  (:attr:`NamedSharding.placements`); :func:`constrain` redistributes a
  ``DTensor`` as JAX's ``with_sharding_constraint`` does, and
  :func:`mesh_ops` lets the plain tensors a model makes (positions,
  masks) meet ``DTensor``s as replicated ones.  There is no fallback: a
  sharding over several distinct devices without a group raises, and
  nothing is moved to one card.  Where a dimension does not divide
  ``model`` (experts, heads, channels), the model code keeps it whole on
  ``model``, as GSPMD does where JAX's ``constrain`` drops the axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any

import numpy as np
import torch

_CURRENT_MESH: list["Mesh | None"] = [None]

# logical name -> preferred mesh axis, in fallback order per tensor
TP_LOGICAL = ("heads", "kv_heads", "mlp", "vocab", "experts", "rec", "inner",
              "head_dim", "head_dim2")


def _device(dev) -> torch.device:
    """A mesh cell's device: ``cuda`` gets the current card's index, so
    that equal devices compare equal; a CUDA device without a card raises.
    ``meta`` (the dry-run's stand-in, no storage) is taken as it is."""
    from repro_torch.core.hdc_model import resolve_device

    if torch.device(dev).type == "meta":
        return torch.device("meta")
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An n-dimensional grid of devices with one name per axis (the
    counterpart of ``jax.sharding.Mesh``).  All devices are of one type,
    ``cuda`` or ``cpu``, or ``meta`` for the dry-run's abstract mesh.

    ``ranks``, where given, is a grid of process-group ranks of the same
    shape: the rank that drives each cell (one process a card).  Such a
    mesh has a ``DeviceMesh`` (:meth:`device_mesh`) and places tensors as
    ``DTensor``s; its devices may repeat (every gloo rank's is ``cpu``)."""

    def __init__(self, devices, axis_names: tuple[str, ...], *, ranks=None):
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
        if ranks is not None:
            ranks = np.asarray(ranks, dtype=np.int64)
            if ranks.shape != cells.shape or len(set(ranks.flat)) != ranks.size:
                raise ValueError(f"ranks {ranks.tolist()} are not one distinct rank a cell of "
                                 f"the {cells.shape} grid")
        self.ranks = ranks
        self._device_mesh = None

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

    @property
    def distributed(self) -> bool:
        """Whether the mesh holds a process group's ranks (one process a card)."""
        return self.ranks is not None

    def local_device(self) -> torch.device:
        """This process's cell's device: the cell of its rank on a
        distributed mesh, else the first cell."""
        if not self.distributed:
            return self.devices.flat[0]
        import torch.distributed as dist

        where = np.argwhere(self.ranks == dist.get_rank())
        if not len(where):
            raise ValueError(f"rank {dist.get_rank()} holds no cell of {self}")
        return self.devices[tuple(where[0])]

    def device_mesh(self):
        """The ``DeviceMesh`` of this mesh's ranks, with its shape and axis
        names.  It needs a process group whose ranks the grid holds; a
        ``meta`` mesh (the dry-run's) gives a ``cpu`` one, for the
        ``fake`` backend."""
        if not self.distributed:
            raise ValueError(
                f"{self} holds no process-group ranks: build it with launch.mesh.mesh_for() "
                "in a process started by `python -m torch.distributed.run`"
            )
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"{self} needs a process group: start the processes with "
                               "`python -m torch.distributed.run` (launch.mesh.init_distributed)")
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            kind = "cuda" if self.platform == "cuda" else "cpu"
            self._device_mesh = DeviceMesh(kind, torch.as_tensor(self.ranks),
                                           mesh_dim_names=self.axis_names)
        return self._device_mesh

    def _key(self):
        ranks = None if self.ranks is None else tuple(self.ranks.flat)
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat),
                ranks)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        ranks = "" if self.ranks is None else f", ranks={self.ranks.flatten().tolist()}"
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]}{ranks})"


def set_current_mesh(mesh: Mesh | None) -> None:
    _CURRENT_MESH[0] = mesh


def get_current_mesh() -> Mesh | None:
    return _CURRENT_MESH[0]


class PartitionSpec(tuple):
    """One entry a dimension: None, a mesh axis name, or a tuple of names
    (the counterpart of ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _placements(axis_names, spec) -> tuple:
    """One placement a mesh dim for `spec` over mesh axes `axis_names`:
    ``Shard(d)`` where the spec names the axis at tensor dim d (an entry
    ``("pod", "data")`` shards dim d on each of those mesh dims, the first
    the major one, as in JAX), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        order = [axis_names.index(n) for n in names if n in axis_names]
        if order != sorted(order):
            raise NotImplementedError(
                f"spec entry {entry} orders mesh axes against the mesh's {axis_names}")
        for n in names:
            if n in where:
                raise ValueError(f"mesh axis {n!r} named twice in {spec}")
            where[n] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in axis_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh.  On a distributed mesh (one process a card, the
    LM path) :meth:`place` makes a ``DTensor``; otherwise ``device`` is
    the one device of the mesh's cells: a mesh that names one device n
    times is accepted (the CPU's forced shards, ``cuda:0`` four times, the
    dry-run's ``meta`` mesh at pod scale), and one over several distinct
    devices with no process group raises."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        if not self.mesh.distributed and len({str(d) for d in self.mesh.devices.flat}) > 1:
            raise NotImplementedError(
                f"a sharding over {self.mesh}: one process places a tensor on one device; "
                "to lay the LM path out over several cards, run one process a card under "
                "`python -m torch.distributed.run` and build the mesh there "
                "(launch.mesh.mesh_for)"
            )

    @property
    def device(self) -> torch.device:
        return self.mesh.local_device()

    @property
    def placements(self) -> tuple:
        """The ``DTensor`` placements of the spec, one a mesh dim."""
        return _placements(self.mesh.axis_names, self.spec)

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """`t` (the whole, global tensor, the same on every rank) laid out by
        this sharding: each rank keeps its own shard of it as a
        ``DTensor`` on a distributed mesh (no collective), else `t` on the
        mesh's device."""
        if not self.mesh.distributed:
            return t.to(self.device)
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(self.device), self.mesh.device_mesh(), self.placements,
                                 src_data_rank=None)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mesh axis names: the tensor-model axis splits the trailing D of the
    HDC state and the LM's tensor-parallel dims; the batch axes (``pod``,
    ``data``, those present) split training batches.  ``fsdp``
    additionally shards the largest free dim of every parameter of at
    least ``fsdp_min_bytes`` (as float32) over the data axis."""

    model_axis: str = "model"
    data_axis: str = "data"
    pod_axis: str = "pod"
    fsdp: bool = False
    fsdp_min_bytes: int = 1 << 21  # 2 MiB

    def batch_axes(self, mesh: Mesh) -> tuple[str, ...]:
        return tuple(a for a in (self.pod_axis, self.data_axis) if a in mesh.axis_names)

    # -- parameters ------------------------------------------------------

    def param_spec(
        self, shape: tuple[int, ...], axes: tuple[str | None, ...], mesh: Mesh
    ) -> PartitionSpec:
        """PartitionSpec for one parameter from its logical axes.  Axes
        that would not divide are dropped, never erred on."""
        model = self.model_axis if self.model_axis in mesh.axis_names else None
        msize = mesh.shape[model] if model else 1
        assign: list[Any] = [None] * len(shape)

        # 0) "batch" logical axis (decode caches / recurrent states):
        #    shard over (pod, data) when divisible
        if "batch" in axes:
            i = axes.index("batch")
            b_axes = self.batch_axes(mesh)
            bsz = math.prod(mesh.shape[a] for a in b_axes) if b_axes else 1
            if b_axes and shape[i] % bsz == 0 and shape[i] >= bsz:
                assign[i] = b_axes if len(b_axes) > 1 else b_axes[0]

        # 1) tensor-parallel axis: first logical TP candidate that divides
        if model:
            for logical in TP_LOGICAL:
                if logical in axes:
                    i = axes.index(logical)
                    if assign[i] is None and shape[i] % msize == 0 and shape[i] >= msize:
                        assign[i] = model
                        break

        # 2) FSDP: largest remaining dim over the data axis, unless the
        # data axis is already used (e.g. a "batch"-sharded decode cache)
        data_used = any(
            self.data_axis == a or (isinstance(a, tuple) and self.data_axis in a)
            for a in assign
        )
        if self.fsdp and not data_used and self.data_axis in mesh.axis_names:
            dsize = mesh.shape[self.data_axis]
            if math.prod(shape) * 4 >= self.fsdp_min_bytes:
                cands = [
                    (shape[i], i)
                    for i in range(len(shape))
                    if assign[i] is None and axes[i] != "layers" and shape[i] % dsize == 0
                ]
                if cands:
                    _, i = max(cands)
                    assign[i] = self.data_axis

        return PartitionSpec(*assign)

    def param_sharding(self, shape, axes, mesh: Mesh) -> NamedSharding:
        return NamedSharding(mesh, self.param_spec(tuple(shape), tuple(axes), mesh))

    # -- activations -----------------------------------------------------

    def activation_spec(self, ndim: int, mesh: Mesh, *, batch_dim: int = 0) -> PartitionSpec:
        """Shard the batch dim over (pod, data); leave the rest unsharded."""
        axes: list[Any] = [None] * ndim
        b = self.batch_axes(mesh)
        if b:
            axes[batch_dim] = b if len(b) > 1 else b[0]
        return PartitionSpec(*axes)

    def data_sharding(self, mesh: Mesh, ndim: int = 2) -> NamedSharding:
        return NamedSharding(mesh, self.activation_spec(ndim, mesh))

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


def is_dtensor(x) -> bool:
    """Whether `x` is a ``DTensor`` (a leaf laid out over a process group)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def model_group(device_mesh, axis: str = "model"):
    """The process group of this rank's peers along `axis` of a
    ``DeviceMesh`` (the ranks that share its other coordinates), in the
    order of their place on `axis`: the group of an expert-parallel
    all-to-all, whose chunk i goes to the owner at place i."""
    if axis not in (device_mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh {device_mesh.mesh_dim_names} has no {axis!r} axis")
    return device_mesh.get_group(axis)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: the
    local gradient of a shard goes back into a DTensor, whose view ops
    need one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_shard(t: torch.Tensor, grad_placements=None) -> torch.Tensor:
    """This rank's shard of the ``DTensor`` t, its gradient handed back as
    a ``DTensor`` with `grad_placements` (default: t's own)."""
    return _ContiguousGrad.apply(t.to_local(grad_placements=grad_placements))


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of `shape` (a ``DTensor``'s global
    stride where ``DTensor.from_local`` is given its shape)."""
    return torch.empty(shape, device="meta").stride()


def _fit_spec(shape, spec, mesh_shape: dict[str, int]) -> PartitionSpec:
    """JAX's rule of ``constrain``: keep the axes of `spec` that the mesh
    has and whose sizes divide the dimension, drop the rest."""
    fixed: list[Any] = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        names = (ax,) if isinstance(ax, str) else tuple(ax)
        names = tuple(n for n in names if n in mesh_shape)
        if not names:
            fixed.append(None)
            continue
        size = math.prod(mesh_shape[n] for n in names)
        if dim % size == 0 and dim >= size:
            fixed.append(names if len(names) > 1 else names[0])
        else:
            fixed.append(None)
    return PartitionSpec(*fixed)


class _MeshAxes:
    """A ``DeviceMesh``'s axis names and sizes, read as ``param_spec``
    reads a :class:`Mesh`."""

    def __init__(self, device_mesh):
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))


def constrain(x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """The LM path's layout hint (JAX's ``with_sharding_constraint`` under
    the current mesh): a ``DTensor`` is redistributed to `spec` on its own
    mesh, with the axes that do not divide dropped, as in JAX (so the
    same model code runs on any device count); a plain tensor (one
    device) is returned as it is."""
    if not is_dtensor(x):
        return x
    dm = x.device_mesh
    names = tuple(dm.mesh_dim_names)
    fixed = _fit_spec(tuple(x.shape), spec, dict(zip(names, dm.shape)))
    placements = _placements(names, fixed)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(dm, placements)


def constrain_batch(x: torch.Tensor, rules: ShardingRules | None = None) -> torch.Tensor:
    """Shard dim 0 over the batch mesh axes (pod, data); a plain tensor is
    returned as it is."""
    if not is_dtensor(x):
        return x
    return constrain(x, (rules or ShardingRules()).activation_spec(x.ndim,
                                                                   _MeshAxes(x.device_mesh)))


def constrain_logical(x: torch.Tensor, axes: tuple, rules: ShardingRules | None = None):
    """A ``DTensor`` laid out by ``rules.param_spec`` of its logical axes
    (the decode state's ``decode_state_axes``); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    spec = (rules or ShardingRules()).param_spec(tuple(x.shape), tuple(axes),
                                                 _MeshAxes(x.device_mesh))
    return constrain(x, spec)


_IMPLICIT_DEPTH = [0]


@contextlib.contextmanager
def mesh_ops(*trees):
    """Where a leaf of `trees` is a ``DTensor``, let the plain tensors the
    model makes (positions, masks, ``arange``s) meet ``DTensor``s as
    replicated ones (``implicit_replication``), for the block; otherwise
    nothing.  Nested blocks keep it on until the outermost one ends."""
    from torch.utils._pytree import tree_leaves

    if _IMPLICIT_DEPTH[0] or not any(is_dtensor(t) for t in tree_leaves(list(trees))):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _IMPLICIT_DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _IMPLICIT_DEPTH[0] -= 1


def tree_param_shardings(mesh: Mesh, spec_tree, axes_tree, rules: ShardingRules):
    """Mirror trees of ParamSpecs + logical axes -> tree of NamedShardings."""

    def walk(spec, axes):
        if isinstance(spec, dict):
            return {k: walk(spec[k], axes[k]) for k in spec}
        return rules.param_sharding(spec.shape, axes, mesh)

    return walk(spec_tree, axes_tree)


def abstract_tensor(shape, dtype, sharding: NamedSharding) -> torch.Tensor:
    """A tensor on the ``meta`` device (shape and dtype, no storage) with
    its sharding beside it as ``.sharding``: the counterpart of
    ``jax.ShapeDtypeStruct(shape, dtype, sharding=...)``."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.sharding = sharding
    return t


def abstract_params(cfg, mesh: Mesh, rules: ShardingRules, dtype=None):
    """The parameter tree as tensors on the ``meta`` device (shapes and
    dtype, no storage): dry-run stand-ins, each with its ``NamedSharding``
    as ``.sharding`` (built as ``tree_param_shardings`` builds it, so a
    mesh that cannot hold the tree raises here too)."""
    from repro_torch.models import params as pmod

    dt = dtype or cfg.pdtype()

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = abstract_tensor(v.shape, dt, rules.param_sharding(v.shape, v.axes, mesh))
        return out

    return walk(pmod.param_specs(cfg))
