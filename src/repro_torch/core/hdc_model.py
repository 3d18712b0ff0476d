"""`HDCModel`: config + codebooks + class-sum state, as an ``nn.Module``.

The torch counterpart of ``repro.core.hdc_model``.  The codebook
(``sobol`` for ``uhd``, ``direction`` for ``uhd_dynamic``, ``p`` and
``level`` for ``baseline``) and the raw int32 class-sum
accumulator ``class_sums`` are registered buffers on one explicit
device; ``n_seen`` is a Python int, exact to 2**64, and crosses
checkpoints as the JAX package's (2,) uint32 [hi, lo] split counter.

As in JAX, ``fit`` and ``partial_fit`` return a new model and leave
this one as it was (a server keeps answering from the old model while
the next is trained); ``partial_fit(donate=True)`` and ``fit_batches``
update the accumulator in place.  The models share the read-only
codebook tensors.

Devices: every entry point takes ``device=None``, meaning ``"cuda"``.
Without a card that raises and names ``device="cpu"``; nothing moves to
the CPU by itself.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch
from torch import nn

from repro_torch.core import encoding, metrics, registry, unary
from repro_torch.core.model import HDCConfig, config_from_manifest, manifest_config
from repro_torch.obs.profiler import span

_NSEEN_LIMIT = 1 << 64


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch datapath on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, got {dev}")
    return dev


def nseen_array(n: int) -> np.ndarray:
    """A count as the (2,) uint32 [hi, lo] split counter of checkpoints."""
    n = int(n)
    if not 0 <= n < _NSEEN_LIMIT:
        raise ValueError(f"n_seen must be in [0, 2**64), got {n}")
    return np.asarray([n >> 32, n & 0xFFFFFFFF], np.uint32)


def nseen_int(a) -> int:
    """Inverse of :func:`nseen_array`; also takes a legacy () scalar."""
    a = np.asarray(a)
    if a.shape == ():
        return nseen_int(nseen_array(int(a)))
    if a.shape != (2,):
        raise ValueError(f"n_seen must be a scalar or (2,) counter, got {a.shape}")
    hi, lo = (int(v) & 0xFFFFFFFF for v in a.astype(np.int64))
    return (hi << 32) | lo


def _centered(cfg: HDCConfig, hv: torch.Tensor) -> torch.Tensor:
    """Apply the packed-inference centering policy before sign-packing.

    "row" subtracts each row's mean over D.  The row sum is taken in
    int64 and converted to float32; the mean is that sum times the
    float32 reciprocal of D, which is what XLA compiles the JAX
    package's ``x.mean(-1)`` to (a division by D differs from it in the
    last bit).  Equal to the JAX package wherever its float32 sum is
    exact (row sums below 2**24), and independent of the reduction order
    on any device.
    """
    if cfg.resolved_pack_center != "row":
        return hv
    return hv.to(torch.float32) - row_mean(hv.to(torch.int64).sum(-1, keepdim=True), hv.shape[-1])


def row_mean(total: torch.Tensor, d: int) -> torch.Tensor:
    """float32 row means from exact int64 row sums over D = `d`: the sum
    converted to float32, times float32(1/d).  A D-sharded model sums its
    shards' int64 row sums first, so its means equal the single-device
    ones bit for bit."""
    inv = torch.full((), float(np.float32(1.0) / np.float32(d)), dtype=torch.float32,
                     device=total.device)
    return total.to(torch.float32) * inv


class HDCModel(nn.Module):
    """Config + codebooks + class-HV accumulator on one device."""

    def __init__(
        self,
        cfg: HDCConfig,
        codebooks: dict[str, torch.Tensor],
        class_sums: torch.Tensor | None = None,
        n_seen: int = 0,
        *,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        expected = set(registry.get_encoder(cfg.encoder).codebook_specs(cfg))
        if set(codebooks) != expected:
            raise ValueError(
                f"codebook layout {sorted(codebooks)} does not match encoder "
                f"{cfg.encoder!r} (expects {sorted(expected)})"
            )
        # an explicit backend that does not run on this device fails here,
        # not at the first request
        registry.resolve_backend(cfg.backend, dev.type, encoder=cfg.encoder)
        self.cfg = cfg
        self._codebook_names = tuple(sorted(codebooks))
        for name in self._codebook_names:
            self.register_buffer(name, torch.as_tensor(codebooks[name]).to(dev))
        if class_sums is None:
            class_sums = torch.zeros((cfg.n_classes, cfg.d), dtype=torch.int32)
        if tuple(class_sums.shape) != (cfg.n_classes, cfg.d):
            raise ValueError(
                f"class_sums shape {tuple(class_sums.shape)} != {(cfg.n_classes, cfg.d)}"
            )
        self.register_buffer("class_sums", class_sums.to(dev, torch.int32))
        self.n_seen = nseen_int(nseen_array(n_seen))

    # -- construction ----------------------------------------------------

    @classmethod
    def create(cls, cfg: HDCConfig, *, device: torch.device | str | None = None) -> "HDCModel":
        """Fresh untrained model: codebooks built, accumulator zeroed."""
        return cls(cfg, registry.get_encoder(cfg.encoder).build_codebooks(cfg), device=device)

    def _with_state(self, class_sums: torch.Tensor, n_seen: int) -> "HDCModel":
        return HDCModel(self.cfg, self.codebooks, class_sums, n_seen, device=self.device)

    def to_device(self, device: torch.device | str | None) -> "HDCModel":
        """This model on `device` (itself when it is already there)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return HDCModel(self.cfg, self.codebooks, self.class_sums, self.n_seen, device=dev)

    # -- derived state ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.class_sums.device

    @property
    def codebooks(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._codebook_names}

    @property
    def encoder(self) -> registry.EncoderBase:
        return registry.get_encoder(self.cfg.encoder)

    @property
    def class_hvs(self) -> torch.Tensor:
        """Inference-time class hypervectors per the binarization policy."""
        if self.cfg.resolved_class_binarize == "sign":
            return encoding.binarize(self.class_sums).to(torch.int32)
        return self.class_sums

    @property
    def n_examples(self) -> int:
        return self.n_seen

    def pack(self) -> torch.Tensor:
        """Class HVs centered per `pack_center`, sign-packed to (C, W)
        int32 words: the pack-once serving artifact."""
        with span("model.pack"):
            return unary.pack_hypervector(_centered(self.cfg, self.class_hvs))

    def pack_queries(self, q: torch.Tensor) -> torch.Tensor:
        """Encoded queries (B, D) -> packed sign bits (B, W), same policy."""
        with span("model.pack"):
            return unary.pack_hypervector(_centered(self.cfg, q))

    # -- core ops --------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        with span("model.copy_in"):
            if isinstance(a, torch.Tensor):
                return a.to(self.device)
            return torch.as_tensor(np.asarray(a)).to(self.device)

    def quantize(self, images) -> torch.Tensor:
        cfg = self.cfg
        x = self._tensor(images)
        with span("model.quantize"):
            return encoding.quantize_images(x, cfg.levels, cfg.max_intensity)

    def encode(self, images) -> torch.Tensor:
        """Raw images (B, H) -> non-binary hypervectors (B, D) int32."""
        x_q = self.quantize(images)
        with span("model.encode"):
            return self.encoder.encode(self.cfg, self.codebooks, x_q, backend=self.cfg.backend)

    def _fit_sums(self, images, labels) -> tuple[torch.Tensor, int]:
        """One block's class sums and size: the span ``model.fit`` (the
        copies in, the quantize and the training kernel's launch)."""
        with span("model.fit"):
            if not isinstance(labels, torch.Tensor):
                # checked on the host before the copy: no round trip through the card
                labels = np.asarray(labels)
            encoding.validate_labels(labels, self.cfg.n_classes)
            labels = self._tensor(labels).to(torch.int32)
            sums = self.encoder.fit_bundle(
                self.cfg, self.codebooks, self.quantize(images), labels, backend=self.cfg.backend
            )
            return sums, int(labels.shape[0])

    def fit(self, images, labels) -> "HDCModel":
        """Single-pass training on this data alone (a new model)."""
        return fit(self, images, labels)

    def partial_fit(self, images, labels, *, donate: bool = False) -> "HDCModel":
        """Accumulate one batch into the class sums.  Returns a new model;
        with ``donate=True`` this model is updated in place and returned."""
        return partial_fit(self, images, labels, donate=donate)

    def fit_batches(self, batches: Iterable[tuple[Any, Any]]) -> "HDCModel":
        """Memory-bounded fit over (images, labels) batches, equal to `fit`
        on their concatenation; this model's state is left as it was."""
        model = self.reset()
        for images, labels in batches:
            model = model.partial_fit(images, labels, donate=True)
        return model

    def reset(self) -> "HDCModel":
        """Drop accumulated class state (codebooks are kept)."""
        return self._with_state(torch.zeros_like(self.class_sums), 0)

    def convert(self, encoder: str) -> "HDCModel":
        """This model under another encoder of the same family, keeping
        its class sums and ``n_seen`` (a copy) and rebuilding the
        codebooks from the config; the backend becomes ``"auto"``.  The
        use: train with the ``uhd`` table, serve table-free with the
        ~1000x smaller ``uhd_dynamic`` codebook.  Conversion across
        families raises ``ValueError``: their class sums do not carry
        over."""
        cur, new = self.encoder, registry.get_encoder(encoder)
        if (cur.family or cur.name) != (new.family or new.name):
            raise ValueError(
                f"cannot convert encoder {cur.name!r} (family {cur.family or cur.name!r}) "
                f"to {new.name!r} (family {new.family or new.name!r}): class sums only "
                "transfer between encoders with bit-identical encode semantics"
            )
        cfg = dataclasses.replace(self.cfg, encoder=encoder, backend="auto")
        return HDCModel(
            cfg, new.build_codebooks(cfg), self.class_sums.clone(), self.n_seen,
            device=self.device,
        )

    def predict(self, images) -> torch.Tensor:
        """Encode queries, score against the class HVs, argmax -> (B,) int32."""
        return predict(self, images)

    def evaluate(self, images, labels, batch_size: int = 1024) -> float:
        """Test accuracy, evaluated in batches."""
        n = len(images)
        correct = 0
        for i in range(0, n, batch_size):
            pred = self.predict(images[i : i + batch_size])
            correct += int((pred == self._tensor(labels[i : i + batch_size])).sum())
        return correct / n

    # -- persistence -----------------------------------------------------

    @property
    def codebook_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.codebooks.values())

    def _state(self) -> dict[str, Any]:
        return {
            "codebooks": self.codebooks,
            "class_sums": self.class_sums,
            "n_seen": nseen_array(self.n_seen),
        }

    def save(self, path: str | Path, *, step: int = 0, keep_n: int = 3) -> None:
        """Atomic checkpoint of one step under `path`, in the JAX package's
        layout and leaf keys; the config rides in the manifest."""
        from repro_torch.checkpoint.manager import CheckpointManager

        CheckpointManager(path, keep_n=keep_n).save(
            step, self._state(), extra={"hdc_config": manifest_config(self.cfg)}
        )

    def save_shard(
        self, path: str | Path, *, step: int = 0, process_index: int, process_count: int,
        keep_n: int = 3,
    ) -> None:
        """Write host `process_index`'s slice of a checkpoint of
        `process_count` per-host D-shards, as the JAX package's
        ``HDCModel.save_shard`` does: leaves whose trailing axis is D
        (``class_sums``, the ``uhd`` table) go to shard files of this
        host's D-slice; replicated leaves and the manifest are host 0's.
        Host 0 writes first (it clears an aborted attempt's staging);
        after every host, ``CheckpointManager(path).finalize_shards(step)``
        publishes, and :meth:`load` stitches the slices back.  One process
        may call it once per simulated host."""
        from repro_torch.checkpoint.manager import CheckpointManager, _flatten, _unflatten

        d = self.cfg.d
        if d % process_count:
            raise ValueError(f"d={d} does not divide over {process_count} checkpoint shards")
        chunk = d // process_count
        sl = slice(process_index * chunk, (process_index + 1) * chunk)
        pairs = _flatten(self._state())
        shard_axes = {k: leaf.ndim - 1 for k, leaf in pairs if leaf.ndim and leaf.shape[-1] == d}
        local = _unflatten([(k, leaf[..., sl] if k in shard_axes else leaf) for k, leaf in pairs])
        CheckpointManager(path, keep_n=keep_n).save_shard(
            step, local, process_index=process_index, process_count=process_count,
            shard_axes=shard_axes, extra={"hdc_config": manifest_config(self.cfg)},
        )

    @classmethod
    def load(
        cls, path: str | Path, *, step: int | None = None,
        device: torch.device | str | None = None, mesh=None, rules=None,
    ) -> "HDCModel | ShardedHDCModel":
        """Restore a checkpoint written by either package (latest step by
        default; gathered or per-host shards) onto `device`, or with
        `mesh` as a :class:`ShardedHDCModel` over it, each D-slice on its
        shard's device (any shard count).  The stored backend name is not
        kept: the datapath follows the device (see
        :func:`config_from_manifest`)."""
        from repro_torch.checkpoint.manager import CheckpointManager

        if mesh is not None:
            if device is not None:
                raise ValueError("pass device or mesh, not both")
            return cls.load(path, step=step, device="cpu").shard(mesh, rules=rules)

        mgr = CheckpointManager(path)
        if step is None:
            step = mgr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
        raw = mgr.extra(step).get("hdc_config")
        if raw is None:
            raise ValueError(f"checkpoint step {step} has no hdc_config manifest")
        cfg = config_from_manifest(raw)
        specs = registry.get_encoder(cfg.encoder).codebook_specs(cfg)
        nseen_shape = tuple(mgr.leaf_meta(step).get("n_seen", {}).get("shape", (2,)))
        like = {
            "codebooks": {k: shape for k, (shape, _) in specs.items()},
            "class_sums": (cfg.n_classes, cfg.d),
            "n_seen": nseen_shape,
        }
        state = mgr.restore(step, like)
        books = {
            k: torch.from_numpy(np.ascontiguousarray(state["codebooks"][k], dtype=dt))
            for k, (_, dt) in specs.items()
        }
        sums = torch.from_numpy(np.ascontiguousarray(state["class_sums"], dtype=np.int32))
        return cls(cfg, books, sums, nseen_int(state["n_seen"]), device=device)

    # -- distribution ----------------------------------------------------

    def shardings(self, mesh, *, rules=None) -> dict[str, str | None]:
        """Checkpoint leaf key -> the mesh axis that splits its trailing D,
        or None (replicated).  D-wide leaves (``class_sums``, the ``uhd``
        table) split over the "model" axis when it is present and divides
        D; everything else replicates: the JAX package's
        ``HDCModel.shardings`` as a plan instead of NamedShardings."""
        from repro_torch.checkpoint.manager import _flatten
        from repro_torch.distributed.sharding import model_axis_for

        axis = model_axis_for(mesh, self.cfg.d, rules=rules)
        return {
            key: axis if axis and leaf.ndim and leaf.shape[-1] == self.cfg.d else None
            for key, leaf in _flatten(self._state())
        }

    def shard(self, mesh, *, rules=None) -> "ShardedHDCModel":
        """This model's state split per :meth:`shardings` over `mesh`."""
        return ShardedHDCModel.from_model(self, mesh, rules=rules)


# ---------------------------------------------------------------------------
# Training and inference steps: the JAX package's module-level ``fit`` /
# ``partial_fit`` / ``predict``, which the HDCModel methods call
# ---------------------------------------------------------------------------


def fit(model: HDCModel, images, labels) -> HDCModel:
    """Single-pass training from scratch: reset, encode, bundle (a new model)."""
    sums, n = model._fit_sums(images, labels)
    return model._with_state(sums, n)


def partial_fit(model: HDCModel, images, labels, *, donate: bool = False) -> HDCModel:
    """Accumulate one batch of bundled class sums into the model.  Returns
    a new model; with ``donate=True`` `model` is updated in place and
    returned."""
    sums, n = model._fit_sums(images, labels)
    if donate:
        n_seen = nseen_int(nseen_array(model.n_seen + n))  # validate before mutating
        model.class_sums += sums
        model.n_seen = n_seen
        return model
    return model._with_state(model.class_sums + sums, model.n_seen + n)


def predict(model: HDCModel, images) -> torch.Tensor:
    """Encode queries, score against class HVs, argmax -> (B,) int32."""
    cfg = model.cfg
    q = model.encode(images)
    if cfg.binarize_query:
        q = encoding.binarize(q).to(torch.int32)
    if cfg.similarity == "hamming":
        sim = metrics.hamming_similarity_packed(
            model.pack_queries(q), model.pack(), cfg.d
        ).to(torch.float32)
    else:
        sim = metrics.SIMILARITIES[cfg.similarity](q, model.class_hvs)
    return metrics.classify(sim)


@dataclasses.dataclass(frozen=True)
class Shard:
    """One D-slice of a sharded model: columns ``[offset, offset +
    d_local)`` of the state, held on ``device`` (its home)."""

    index: int
    offset: int
    device: torch.device
    class_sums: torch.Tensor  # (C, d_local) int32 on device


def _cell_device(mesh, axis: str | None, group: dict[str, int], j: int) -> torch.device:
    """The mesh cell of batch shard `group` (positions on the batch axes)
    and D-slice `j`; 0 on every other axis."""
    return mesh.device_at({**group, axis: j} if axis else group)


def _slice_to(t: torch.Tensor, sl: slice | None, device: torch.device) -> torch.Tensor:
    """A fresh contiguous copy of ``t[..., sl]`` (all of `t` when `sl` is
    None) on `device`: the kernels read table slices with 16-byte loads."""
    src = t if sl is None else t[..., sl]
    return torch.empty(src.shape, dtype=src.dtype, device=device).copy_(src)


class ShardedHDCModel:
    """An `HDCModel`'s state split along D over a mesh's "model" axis: the
    port's counterpart of a JAX ``HDCModel`` placed by
    ``shard(mesh)``.

    Shard j's class sums live on its home device, the mesh cell at
    position j of the model axis and 0 on every other axis.  Every cell
    that computes for slice j (one per batch shard in training) holds
    slice j of the D-wide codebooks and a copy of the replicated ones,
    made contiguous once, here.  When the model axis is absent or does
    not divide D, there is one shard holding all of D.  Class sums are
    read back whole through :attr:`class_sums` or :meth:`gather`;
    `evaluate`, `save` and `save_shard` run on the gathered model, while
    :func:`partial_fit_sharded` and ``ShardedExecution`` run shard by
    shard.
    """

    def __init__(self, cfg: HDCConfig, mesh, rules, books: dict, shards: list[Shard],
                 n_seen: int):
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules
        self._books = books  # (shard index, device) -> codebook slice
        self.shards = shards
        self.n_seen = nseen_int(nseen_array(n_seen))

    @classmethod
    def from_model(cls, model: HDCModel, mesh, *, rules=None) -> "ShardedHDCModel":
        from repro_torch.distributed.sharding import ShardingRules, model_axis_for

        rules = rules or ShardingRules()
        cfg = model.cfg
        registry.resolve_backend(cfg.backend, mesh.platform, encoder=cfg.encoder)
        axis = model_axis_for(mesh, cfg.d, rules=rules)
        n = mesh.shape[axis] if axis else 1
        width = cfg.d // n
        split = model.shardings(mesh, rules=rules)
        books, shards = {}, []
        for j in range(n):
            sl = slice(j * width, (j + 1) * width) if axis else None
            for group in rules.batch_groups(mesh):
                dev = _cell_device(mesh, axis, group, j)
                if (j, dev) not in books:
                    books[j, dev] = {
                        k: _slice_to(v, sl if split[f"codebooks/{k}"] else None, dev)
                        for k, v in model.codebooks.items()
                    }
            home = _cell_device(mesh, axis, {}, j)
            shards.append(Shard(j, j * width, home, _slice_to(model.class_sums, sl, home)))
        return cls(cfg, mesh, rules, books, shards, model.n_seen)

    def _with_state(self, sums: list[torch.Tensor], n_seen: int) -> "ShardedHDCModel":
        shards = [dataclasses.replace(sh, class_sums=t) for sh, t in zip(self.shards, sums)]
        return ShardedHDCModel(self.cfg, self.mesh, self.rules, self._books, shards, n_seen)

    # -- layout ----------------------------------------------------------

    @property
    def axis(self) -> str | None:
        from repro_torch.distributed.sharding import model_axis_for

        return model_axis_for(self.mesh, self.cfg.d, rules=self.rules)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def d_local(self) -> int:
        return self.cfg.d // self.n_shards

    @property
    def device(self) -> torch.device:
        """The output device: where partials are summed and results land."""
        return self.shards[0].device

    def books(self, j: int, device: torch.device) -> dict[str, torch.Tensor]:
        """Slice `j` of the codebooks as held on `device`."""
        return self._books[j, device]

    # -- state -----------------------------------------------------------

    @property
    def encoder(self) -> registry.EncoderBase:
        return registry.get_encoder(self.cfg.encoder)

    @property
    def n_examples(self) -> int:
        return self.n_seen

    @property
    def class_sums(self) -> torch.Tensor:
        """The (C, D) class sums, gathered on the output device."""
        return torch.cat([sh.class_sums.to(self.device) for sh in self.shards], dim=1)

    @property
    def codebooks(self) -> dict[str, torch.Tensor]:
        """The whole codebooks, gathered on the output device."""
        specs = self.encoder.codebook_specs(self.cfg)
        homes = [self.books(sh.index, sh.device) for sh in self.shards]
        return {
            k: torch.cat([b[k].to(self.device) for b in homes], dim=-1)
            if self.axis and shape[-1] == self.cfg.d else homes[0][k]
            for k, (shape, _) in specs.items()
        }

    @property
    def codebook_bytes(self) -> int:
        specs = self.encoder.codebook_specs(self.cfg)
        return sum(int(np.prod(shape)) * np.dtype(dt).itemsize for shape, dt in specs.values())

    def gather(self, device: torch.device | str | None = None) -> HDCModel:
        """The whole model on `device` (default: the output device)."""
        return HDCModel(self.cfg, self.codebooks, self.class_sums, self.n_seen,
                        device=self.device if device is None else device)

    def shard(self, mesh, *, rules=None) -> "ShardedHDCModel":
        """This model over `mesh` (itself when it is already there)."""
        if mesh == self.mesh and (rules or self.rules) == self.rules:
            return self
        return self.gather().shard(mesh, rules=rules)

    # -- the gathered entry points ---------------------------------------

    def evaluate(self, images, labels, batch_size: int = 1024) -> float:
        return self.gather().evaluate(images, labels, batch_size)

    def save(self, path: str | Path, *, step: int = 0, keep_n: int = 3) -> None:
        self.gather().save(path, step=step, keep_n=keep_n)

    def save_shard(self, path: str | Path, *, step: int = 0, process_index: int,
                   process_count: int, keep_n: int = 3) -> None:
        self.gather().save_shard(path, step=step, process_index=process_index,
                                 process_count=process_count, keep_n=keep_n)


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def partial_fit_sharded(model, images, labels, *, mesh, rules=None) -> ShardedHDCModel:
    """The multi-device `partial_fit` (the JAX package's shard_map step).

    The batch splits over the mesh's batch axes (``pod``, ``data``) into
    equal row blocks; every (batch shard, D-slice) cell computes the
    (C, d_local) class sums of its rows through the fused ``fit_bundle``
    datapath on its own device, a ``uhd_dynamic`` cell generating only
    the Sobol points of its slice (``point_offset``); the partials of a
    slice are summed on its home device (the JAX package's one psum) and
    added to the slice's class sums.  Integer arithmetic throughout, so
    the result equals single-device ``partial_fit`` on the whole batch
    bit for bit.  `model` is an `HDCModel` or a `ShardedHDCModel`; it is
    placed on `mesh` first when it is not there.  Returns a new model.
    """
    from repro_torch.distributed.sharding import ShardingRules

    rules = rules or ShardingRules()
    model = model.shard(mesh, rules=rules)
    cfg, enc = model.cfg, model.encoder
    images, labels = _host_tensor(images), _host_tensor(labels)
    encoding.validate_labels(labels, cfg.n_classes)
    groups = rules.batch_groups(mesh)
    n = int(labels.shape[0])
    if n % len(groups):
        raise ValueError(
            f"global batch {n} must divide the {len(groups)}-way batch mesh axes "
            f"{rules.batch_axes(mesh)}"
        )
    per, axis = n // len(groups), model.axis
    cells: dict = {}  # (batch shard, device) -> quantized rows and labels there
    sums = []
    for sh in model.shards:
        total = None
        for g, group in enumerate(groups):
            dev = _cell_device(mesh, axis, group, sh.index)
            if (g, dev) not in cells:
                rows = slice(g * per, (g + 1) * per)
                x = images[rows].to(dev)
                cells[g, dev] = (
                    encoding.quantize_images(x, cfg.levels, cfg.max_intensity),
                    labels[rows].to(dev, torch.int32),
                )
            x_q, y = cells[g, dev]
            part = enc.fit_bundle(
                cfg, model.books(sh.index, dev), x_q, y, backend=cfg.backend,
                d=model.d_local, point_offset=sh.offset if enc.dynamic_generator else None,
            ).to(sh.device)
            total = part if total is None else total + part
        sums.append(sh.class_sums + total)
    return model._with_state(sums, model.n_seen + n)


def train_and_eval(
    cfg: HDCConfig, train_images, train_labels, test_images, test_labels,
    batch_size: int = 2048, *, device: torch.device | str | None = None,
    on_model=None,
) -> float:
    """Create, fit in batches of `batch_size`, evaluate: the test
    accuracy.  ``on_model(model)``, when given, sees the trained model."""
    model = HDCModel.create(cfg, device=device)
    model = model.fit_batches(
        (train_images[i : i + batch_size], train_labels[i : i + batch_size])
        for i in range(0, len(train_images), batch_size)
    )
    if on_model is not None:
        on_model(model)
    return model.evaluate(test_images, test_labels)


def baseline_iterative_search(
    base_cfg: HDCConfig, train_images, train_labels, test_images, test_labels,
    iterations: int, batch_size: int = 2048, *, device: torch.device | str | None = None,
    on_model=None,
) -> list[float]:
    """The paper's baseline protocol (Table IV, Fig. 6(a)): for each
    iteration i, draw new pseudo-random P and L (``seed=i``), retrain from
    scratch and record the test accuracy.  The backend resets to
    ``"auto"``, as backend names are per encoder.  ``on_model(i, model)``,
    when given, sees each trained model."""
    accs = []
    for i in range(iterations):
        cfg = dataclasses.replace(base_cfg, encoder="baseline", seed=i, backend="auto")
        hook = None if on_model is None else (lambda m, i=i: on_model(i, m))
        accs.append(train_and_eval(
            cfg, train_images, train_labels, test_images, test_labels, batch_size,
            device=device, on_model=hook,
        ))
    return accs


# ---------------------------------------------------------------------------
# Packed serving path (the JAX package's predict_packed / search_packed)
# ---------------------------------------------------------------------------


def search_packed(
    model: HDCModel, images, item_words: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode queries, scan a packed (C, W) store, return the k nearest
    rows per query: ((B, k) int32 indices, (B, k) int32 Hamming
    distances), ascending by (distance, index).  The model's backend
    picks the scan: the kernel on a card, the tiled plain version on
    the CPU; both equal ``kernels.ref.hamming_topk_oracle``."""
    cfg = model.cfg
    q = model.encode(images)
    if cfg.binarize_query:
        q = encoding.binarize(q).to(torch.int32)
    return model.encoder.topk(
        model.pack_queries(q), item_words, cfg.d, k, backend=cfg.backend
    )


def predict_packed(model: HDCModel, images, class_words: torch.Tensor) -> torch.Tensor:
    """Serving fast path: the k=1 case of :func:`search_packed`; labels
    equal ``predict`` with ``similarity="hamming"``."""
    indices, _ = search_packed(model, images, class_words, k=1)
    return indices[:, 0]
