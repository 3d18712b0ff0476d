"""Execution backends: where a packed-predict engine runs.

The torch counterpart of ``repro.serving.execution``.  A backend owns
the placement-sensitive steps of serving: ``place(model)``,
``pack(model)`` (the pack-once class words, in the layout its own
``predict`` reads) and ``predict``/``search`` of a request batch.

:class:`DeviceExecution`
    The model and every request on one device.

:class:`ShardedExecution`
    D-partitioned packed predict over a ``("model",)`` mesh, the
    inference twin of ``partial_fit_sharded``.  Every shard encodes its
    own D-slice of the queries (a ``uhd_dynamic`` shard generates only
    the Sobol points of its slice; a ``uhd`` shard reads its table
    columns), centres it, packs it and scores it against its slice of
    the class words with the ``hamming_packed`` kernel; the sum of the
    (B, C) int32 partials on the output device is the JAX package's one
    psum, exact because ``sum_k (d_k - 2 pc_k) = d - 2 pc``.  Pad bits of
    each shard's last word are zero in both operands and cancel, so
    ``d_local % 32 != 0`` needs nothing.  Row centring sums the shards'
    int64 row sums before the float32 mean, so it equals the
    single-device centring bit for bit.

:func:`plan_executions` turns a fleet request (N replicas over a device
list) into backends: contiguous device groups, sharded where a group
has several devices and D divides, pinned to one device otherwise.
``resolve_impl`` lives in ``core.registry``.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding, metrics, unary
from repro_torch.core.hdc_model import (
    HDCModel,
    ShardedHDCModel,
    predict_packed,
    resolve_device,
    row_mean,
    search_packed,
)
from repro_torch.core.registry import resolve_impl
from repro_torch.distributed.sharding import (
    Mesh,
    ShardingRules,
    local_devices,
    model_axis_for,
    model_mesh,
)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

__all__ = [
    "DeviceExecution", "PLACEMENTS", "ShardedExecution", "plan_executions", "resolve_impl",
]

PLACEMENTS = ("auto", "device", "sharded")


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

    def load(self, path, step: int) -> HDCModel:
        return HDCModel.load(path, step=step, device=self.device)

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


def _centered_shards(cfg, hvs: list[torch.Tensor], out: torch.device) -> list[torch.Tensor]:
    """Per-shard twin of ``hdc_model._centered``: "row" centring needs the
    mean over the whole D, so the shards' int64 row sums are summed on
    the output device first (exact), and every shard subtracts the same
    float32 mean."""
    if cfg.resolved_pack_center != "row":
        return hvs
    total = sum(h.to(torch.int64).sum(-1, keepdim=True).to(out) for h in hvs)
    mean = row_mean(total, cfg.d)
    return [h.to(torch.float32) - mean.to(h.device) for h in hvs]


class ShardedExecution:
    """D-partitioned packed predict and search over a ``("model",)`` mesh
    (see the module docstring).  ``devices`` may name one device several
    times: the shards then run one after another on it."""

    placement = "sharded"

    def __init__(self, mesh: Mesh | None = None, *, devices=None,
                 rules: ShardingRules | None = None):
        if mesh is not None and devices is not None:
            raise ValueError("pass mesh or devices, not both")
        self.rules = rules or ShardingRules()
        self.mesh = mesh if mesh is not None else model_mesh(devices, rules=self.rules)
        self.impl = resolve_impl("auto", self.mesh.platform)

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.rules.model_axis])

    def _check(self, d: int) -> None:
        if model_axis_for(self.mesh, d, rules=self.rules) is None:
            raise ValueError(
                f"cannot shard D={d} over mesh {self.mesh.shape}: the "
                f"{self.rules.model_axis!r} axis must be present and divide D"
            )

    def place(self, model: HDCModel | ShardedHDCModel) -> ShardedHDCModel:
        self._check(model.cfg.d)  # loud, not graceful: sharding was requested
        return model.shard(self.mesh, rules=self.rules)

    def load(self, path, step: int) -> ShardedHDCModel:
        return HDCModel.load(path, step=step, mesh=self.mesh, rules=self.rules)

    def pack(self, model: HDCModel | ShardedHDCModel) -> list[torch.Tensor]:
        """Per-shard class words: shard j's (C, n_words(d_local)) int32
        words of its centred class-sum slice, on its device."""
        model = self.place(model)
        hvs = [sh.class_sums for sh in model.shards]
        if model.cfg.resolved_class_binarize == "sign":
            hvs = [encoding.binarize(h).to(torch.int32) for h in hvs]
        return [unary.pack_hypervector(h) for h in _centered_shards(model.cfg, hvs, model.device)]

    def shard_words(self, words: torch.Tensor, d: int) -> list[torch.Tensor]:
        """A (C, n_words(d)) store packed over the whole D (e.g. an
        `ItemMemory`'s rows) as per-shard words on the shards' devices,
        in the layout :meth:`pack` gives."""
        self._check(d)
        n = self.n_shards
        width = d // n
        if width % unary.WORD == 0:  # a slice is whole words
            w = width // unary.WORD
            parts = [words[:, j * w : (j + 1) * w] for j in range(n)]
        else:
            bits = unary.unpack_bits(words, d)
            parts = [unary.pack_bits(bits[:, j * width : (j + 1) * width]) for j in range(n)]
        devs = [self.mesh.device_at({self.rules.model_axis: j}) for j in range(n)]
        return [p.to(dev).contiguous() for p, dev in zip(parts, devs)]

    def _partial_scores(self, model: ShardedHDCModel, words: list[torch.Tensor], images):
        """Each shard's (B, C) int32 partial score d_local - 2 pc_local of
        the queries' slice against its words, on its device."""
        cfg, enc = model.cfg, model.encoder
        images = images if isinstance(images, torch.Tensor) else torch.as_tensor(images)
        x_q: dict[torch.device, torch.Tensor] = {}
        hvs = []
        for sh in model.shards:
            if sh.device not in x_q:
                x_q[sh.device] = encoding.quantize_images(
                    images.to(sh.device), cfg.levels, cfg.max_intensity
                )
            q = enc.encode_slice(
                cfg, model.books(sh.index, sh.device), x_q[sh.device], backend=cfg.backend,
                d=model.d_local, point_offset=sh.offset if enc.dynamic_generator else None,
            )
            if cfg.binarize_query:
                q = encoding.binarize(q).to(torch.int32)
            hvs.append(q)
        return [
            ops.hamming_packed(unary.pack_hypervector(q), w, model.d_local)
            for q, w in zip(_centered_shards(cfg, hvs, model.device), words)
        ]

    def predict(self, model, class_words: list[torch.Tensor], images) -> torch.Tensor:
        """(B,) int32 labels: argmax of the summed scores, lowest index on ties."""
        model = self.place(model)
        parts = self._partial_scores(model, class_words, images)
        return metrics.classify(sum(p.to(model.device) for p in parts))

    def search(
        self, model, class_words: list[torch.Tensor], images, k: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The k nearest rows per query, ((B, k) int32 indices, (B, k) int32
        distances) ascending by (distance, index): every shard's partial
        popcount (d_local - score) / 2 summed on the output device, then
        the pinned top-k of the whole (B, C) distances (plain torch ops)."""
        model = self.place(model)
        parts = self._partial_scores(model, class_words, images)
        dist = sum(((model.d_local - p) // 2).to(model.device) for p in parts)
        return kref.topk_pinned(dist, int(k))

    def describe(self) -> dict:
        return {
            "placement": self.placement,
            "impl": self.impl,
            "n_shards": self.n_shards,
            "devices": [str(dev) for dev in self.mesh.devices.flat],
        }


def _device_groups(devices: list, replicas: int) -> list[list]:
    """Contiguous near-even device groups, one per replica; more replicas
    than devices cycles single devices."""
    n = len(devices)
    if replicas > n:
        return [[devices[i % n]] for i in range(replicas)]
    base, extra = divmod(n, replicas)
    groups, at = [], 0
    for i in range(replicas):
        size = base + (1 if i < extra else 0)
        groups.append(list(devices[at : at + size]))
        at += size
    return groups


def plan_executions(d: int, *, replicas: int = 1, placement: str = "auto", devices=None) -> list:
    """Fleet plan: one execution backend per replica over a device list
    (default: every visible card).

    ``placement``:
      * ``"auto"``: one replica runs on the first device; several split
        the devices into contiguous groups, sharding a group of several
        devices when D divides over it, pinning its first device otherwise;
      * ``"device"``: every replica pins one device (round-robin);
      * ``"sharded"``: every replica shards its whole group, and D that
        does not divide over a group raises.
    """
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}; valid: {', '.join(PLACEMENTS)}")
    replicas = int(replicas)
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    devs = list(devices) if devices is not None else local_devices()
    if placement == "auto" and replicas == 1:
        return [DeviceExecution(device=devs[0])]
    if placement == "device":
        return [DeviceExecution(device=devs[i % len(devs)]) for i in range(replicas)]
    execs = []
    for group in _device_groups(devs, replicas):
        if placement == "sharded" and d % len(group):
            raise ValueError(
                f"placement='sharded': D={d} does not divide over a {len(group)}-device "
                "group; adjust the replicas or D"
            )
        if placement == "sharded" or (len(group) > 1 and d % len(group) == 0):
            execs.append(ShardedExecution(devices=group))
        else:
            execs.append(DeviceExecution(device=group[0]))
    return execs
