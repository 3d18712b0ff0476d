"""The paper's system end to end: uHD single-pass training.

    PYTHONPATH=src python -m repro_torch.launch.train_hdc                # on the card
    PYTHONPATH=src python -m repro_torch.launch.train_hdc --device cpu --d 1024
    PYTHONPATH=src python -m repro_torch.launch.train_hdc --shard-map --ckpt-shards 4 \
        --save-dir /tmp/hdc
    PYTHONPATH=src python -m repro_torch.launch.train_hdc --encoder baseline \
        --compare-baseline --baseline-iters 5
    PYTHONPATH=src python -m repro_torch.launch.train_hdc --dataset cifar100 \
        --encoder uhd_dynamic --n-train 50000 --n-test 10000

The torch counterpart of ``repro.launch.train_hdc``, with its defaults:
create -> fit_batches (streamed, one fused training step a batch), or
with ``--shard-map`` ``partial_fit_sharded`` a batch over ``mesh_for()``
(every visible card, or the CPU) -> evaluate (cosine ``predict``) ->
with ``--save-dir``, save (with ``--ckpt-shards N``, as N per-host
D-shards written from this process, then published), load and check
the round trip.  ``--compare-baseline`` then runs the paper's baseline
protocol (``baseline_iterative_search``): ``--baseline-iters`` full
retrains of the ``baseline`` encoder with seeds 0, 1, ..., printing the
average and best accuracy.  The device is the only datapath switch: on
the card the ``uhd`` encoder runs the CUDA kernels ``fit_bundle`` and
``encode_bundle``, ``baseline`` the kernels ``encode_unary_mxu`` and
``bundle_binarize``; on the CPU their plain versions run.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import (
    HDCConfig,
    HDCModel,
    ShardedHDCModel,
    baseline_iterative_search,
    partial_fit_sharded,
)
from repro_torch.core.hdc_model import resolve_device
from repro_torch.data import load_dataset
from repro_torch.distributed.sharding import get_current_mesh, set_current_mesh
from repro_torch.launch.mesh import describe, mesh_for


@dataclasses.dataclass
class TrainResult:
    model: HDCModel | ShardedHDCModel
    accuracy: float
    fit_s: float  # fit_batches wall seconds, synchronised
    eval_s: float  # evaluate wall seconds
    round_trip_ok: bool | None  # None without --save-dir
    baseline_accs: list[float] = dataclasses.field(default_factory=list)


def _sync(devices) -> None:
    """Wait for every distinct card of `devices`: a sharded fit leaves each
    slice's sums on its own card."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def train(args, on_retrain=None) -> TrainResult:
    """Train, evaluate and (with ``args.save_dir``) checkpoint one model.

    With ``args.compare_baseline``, ``on_retrain(i, model)``, when given,
    sees each retrained baseline model as it is trained.  No retrained
    model is kept: each holds its codebooks and, on a card, their cached
    [P == L] operand (109 MB at D = 8192), so keeping them would grow
    with ``--baseline-iters``.  ``--shard-map`` makes its mesh current
    for the run; the caller's current mesh is back when it returns."""
    previous = get_current_mesh()
    try:
        return _train(args, on_retrain)
    finally:
        set_current_mesh(previous)


def _train(args, on_retrain) -> TrainResult:
    device = resolve_device(args.device)
    ds = load_dataset(args.dataset, n_train=args.n_train, n_test=args.n_test)
    tag = " (synthetic)" if ds.synthetic else ""
    print(f"dataset {ds.name}{tag}: {ds.train_images.shape[0]} train / "
          f"{ds.test_images.shape[0]} test, {ds.n_classes} classes")
    cfg = HDCConfig(
        n_features=ds.n_features, n_classes=ds.n_classes, d=args.d,
        levels=args.levels, encoder=args.encoder,
    )

    def batches():
        for i in range(0, len(ds.train_images), args.batch_size):
            yield (ds.train_images[i : i + args.batch_size],
                   ds.train_labels[i : i + args.batch_size])

    fresh = HDCModel.create(cfg, device=device)
    fit_devices = [device]
    t0 = time.perf_counter()
    if args.shard_map:
        mesh = mesh_for(devices=None if device.type == "cuda" else [device])
        set_current_mesh(mesh)
        model = fresh.shard(mesh)
        for images, labels in batches():
            model = partial_fit_sharded(model, images, labels, mesh=mesh)
        mode = f"shard_map {describe(mesh)}"
        fit_devices = list(mesh.devices.flat)
    else:
        model = fresh.fit_batches(batches())
        mode = "single device"
    _sync(fit_devices)
    t1 = time.perf_counter()
    acc = model.evaluate(ds.test_images, ds.test_labels)
    t2 = time.perf_counter()
    print(f"{args.encoder}  D={args.d} device={device.type} [{mode}]: accuracy {acc:.4f}  "
          f"({model.n_examples} images, single pass, fit {t1 - t0:.3f}s, "
          f"evaluate {t2 - t1:.3f}s)")

    ok = None
    if args.save_dir:
        if args.ckpt_shards > 1:
            for pi in range(args.ckpt_shards):
                model.save_shard(args.save_dir, step=0, process_index=pi,
                                 process_count=args.ckpt_shards)
            CheckpointManager(args.save_dir).finalize_shards(0)
        else:
            model.save(args.save_dir, step=0)
        restored = HDCModel.load(args.save_dir, device=device)
        ok = restored.cfg == model.cfg and torch.equal(
            restored.class_sums, model.class_sums.to(device)
        )
        shard_note = f", {args.ckpt_shards} host shards" if args.ckpt_shards > 1 else ""
        print(f"checkpointed to {args.save_dir} (round-trip ok: {ok}{shard_note})")
    result = TrainResult(model, acc, t1 - t0, t2 - t1, ok)

    if args.compare_baseline:
        t0 = time.perf_counter()
        result.baseline_accs = baseline_iterative_search(
            cfg, ds.train_images, ds.train_labels, ds.test_images, ds.test_labels,
            iterations=args.baseline_iters, batch_size=args.batch_size, device=device,
            on_model=on_retrain,
        )
        accs = result.baseline_accs
        print(
            f"baseline HDC over i=1..{args.baseline_iters}: "
            f"avg {np.mean(accs):.4f} best {np.max(accs):.4f} "
            f"({time.perf_counter() - t0:.1f}s, {args.baseline_iters} full retrains)"
        )
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synth_mnist",
                    help="mnist or cifar100 (their files under $REPRO_DATA_DIR, else a "
                         "synthetic set of their shape), or a synth_* set")
    ap.add_argument("--d", type=int, default=8192)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--n-test", type=int, default=1024)
    ap.add_argument("--encoder", default="uhd",
                    help="registered encoder (uhd | uhd_dynamic | baseline)")
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument(
        "--shard-map", action="store_true",
        help="train through partial_fit_sharded over mesh_for() (batch shards summed, "
             "per-D-slice generation); bit-identical class sums",
    )
    ap.add_argument("--save-dir", default=None, help="checkpoint the trained HDCModel here")
    ap.add_argument(
        "--ckpt-shards", type=int, default=0,
        help="with --save-dir: write the checkpoint as N per-host D-shards "
             "(simulated hosts in this process) and verify the stitched restore",
    )
    ap.add_argument("--compare-baseline", action="store_true",
                    help="then retrain the baseline encoder --baseline-iters times "
                         "(seeds 0, 1, ...) and print its average and best accuracy")
    ap.add_argument("--baseline-iters", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the kernels run on cuda, the plain versions on cpu")
    return ap


def main(argv=None) -> int:
    result = train(parser().parse_args(argv))
    return 0 if result.round_trip_ok in (None, True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
