"""HDC inference service driver: train -> checkpoint -> load -> serve.

    PYTHONPATH=src python -m repro_torch.launch.serve_hdc --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_hdc --smoke --device cpu

The torch counterpart of ``repro.launch.serve_hdc``: a trained
`HDCModel` is checkpointed, loaded into a `ServingEngine` (class HVs
binarized and packed once; on a card the static-shape step captured as
a CUDA graph), registered in a `ModelRegistry`, and a synthetic request
stream is pushed through the slot-based micro-batcher one image at a
time.  ``--smoke`` runs the whole loop on a synthetic dataset and
exercises hot reload mid-stream: the trainer continues with
``partial_fit`` and publishes step 1, the second half of the stream is
queued, and the registry swaps engines with those requests queued,
dropping none; each request's serving step is recorded.  Prints p50/p99
latency, throughput (img/s), batch occupancy and served accuracy.

Serving an existing checkpoint (either package's):

    PYTHONPATH=src python -m repro_torch.launch.serve_hdc --ckpt /path/to/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import HDCConfig, HDCModel
from repro_torch.data import load_dataset
from repro_torch.serving import ModelRegistry, ServingEngine


def _sync(device: torch.device) -> None:
    """Wait for this thread's work on `device` (its current stream alone)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _print_stats(name: str, snap: dict, n_served: int, serve_wall_s: float) -> None:
    # throughput over the serving wall clock only (the snapshot's
    # elapsed_s also spans non-serving work like retraining/reloads)
    print(
        f"[{name}] served {n_served} requests in "
        f"{serve_wall_s:.2f}s: {n_served / serve_wall_s:.1f} img/s | "
        f"latency p50 {snap['p50_ms']:.2f}ms p99 {snap['p99_ms']:.2f}ms "
        f"mean {snap['mean_ms']:.2f}ms | {snap['n_batches']} batches, "
        f"occupancy {snap['batch_occupancy']:.2f}, "
        f"reloads {snap['n_reloads']}, errors {snap['n_errors']}"
    )


@dataclasses.dataclass
class Served:
    """One stretch of the request stream, in request order."""

    labels: np.ndarray  # (n,) int32
    steps: np.ndarray  # (n,) the checkpoint step that served each request
    latency_s: np.ndarray  # (n,) submit-to-resolve seconds
    wall_s: float  # from the first submit (or the reload) to the last result


def _collect(futures, t0: float, *, timeout: float = 120.0) -> Served:
    labels = np.asarray([f.result(timeout=timeout) for f in futures], np.int32)
    wall = time.perf_counter() - t0
    steps = np.asarray([f.trace.step for f in futures])
    return Served(labels, steps, np.asarray([f.latency_s() for f in futures]), wall)


def _serve_stream(registry: ModelRegistry, name: str, images: np.ndarray) -> Served:
    """Push images one request at a time; results in order + wall seconds."""
    t0 = time.perf_counter()
    return _collect([registry.submit(name, img) for img in images], t0)


@dataclasses.dataclass
class SmokeResult:
    models: tuple[HDCModel, HDCModel]  # the trained models of steps 0 and 1
    engines: tuple[ServingEngine, ServingEngine]  # the served engines of steps 0 and 1
    probe: np.ndarray  # the images of the parity check
    accuracy: float
    fit_s: tuple[float, float]  # fit and partial_fit wall seconds, synchronised
    served: tuple[Served, Served]  # the stream's halves, before and after the reload
    queued_at_reload: int  # requests in the batcher's queue when the reload swapped
    metrics: dict  # the batcher's `ServingMetrics.snapshot()` after the stream

    @property
    def labels(self) -> np.ndarray:
        return np.concatenate([s.labels for s in self.served])

    @property
    def steps(self) -> np.ndarray:
        return np.concatenate([s.steps for s in self.served])


def smoke(args) -> SmokeResult:
    """The whole train -> checkpoint -> serve -> retrain -> hot-reload loop."""
    device = torch.device(args.device)
    ds = load_dataset(args.dataset, n_train=args.n_train, n_test=args.requests)
    cfg = HDCConfig(
        n_features=ds.n_features, n_classes=ds.n_classes, d=args.d,
        levels=args.levels, encoder=args.encoder,
    )
    name = args.encoder
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="hdc_serve_smoke_")

    # -- train + publish step 0 (first half of the training stream) ------
    half = len(ds.train_images) // 2
    fresh = HDCModel.create(cfg, device=device)
    t0 = time.perf_counter()
    model0 = fresh.fit(ds.train_images[:half], ds.train_labels[:half])
    _sync(device)
    fit0 = time.perf_counter() - t0
    model0.save(ckpt_dir, step=0)
    print(f"trained on {half} images ({fit0:.3f}s) + checkpointed step 0 -> {ckpt_dir}")

    # -- load behind the service -----------------------------------------
    registry = ModelRegistry()
    try:
        # pin step 0 explicitly: a reused --ckpt dir may hold newer stale steps
        batcher = registry.register_checkpoint(
            name, ckpt_dir, step=0, batch_size=args.batch, devices=[device], start=True
        )
        engine0 = registry.engine(name)
        print(f"engine loaded: {engine0.describe()}")

        # parity: the packed path must agree with HDCModel.predict (hamming)
        probe = ds.test_images[: args.batch]
        served = engine0.predict(probe)
        model_h = HDCModel(
            dataclasses.replace(engine0.model.cfg, similarity="hamming"),
            engine0.model.codebooks, engine0.model.class_sums, engine0.model.n_seen,
            device=device,
        )
        direct = model_h.predict(probe).cpu().numpy()
        if not np.array_equal(served, direct):
            raise AssertionError("packed path diverged from HDCModel.predict(similarity='hamming')")
        print(f"packed-path parity vs HDCModel.predict: OK ({len(probe)} images)")

        # -- serve the first half of the stream ---------------------------
        n1 = len(ds.test_images) // 2
        first = _serve_stream(registry, name, ds.test_images[:n1])

        # -- trainer publishes step 1; the service hot-reloads with the
        #    rest of the stream queued -------------------------------------
        t0 = time.perf_counter()
        model1 = engine0.model.partial_fit(ds.train_images[half:], ds.train_labels[half:])
        _sync(device)
        fit1 = time.perf_counter() - t0
        model1.save(ckpt_dir, step=1)
        with batcher.hold():  # the drain takes nothing until the swap is done
            futures = [registry.submit(name, img) for img in ds.test_images[n1:]]
            queued = batcher.queue_depth()
            swapped = registry.hot_reload(name, step=1)  # pinned: dir may be reused
        t_reloaded = time.perf_counter()
        if swapped != 1:
            raise AssertionError(f"expected hot reload to step 1, got {swapped}")
        engine1 = registry.engine(name)
        print(f"hot-reloaded to step {swapped} (n_seen {engine1.model.n_examples}, "
              f"partial_fit {fit1:.3f}s) with {queued} requests queued")

        # -- the queued rest of the stream, served by the new engine -------
        second = _collect(futures, t_reloaded)
    finally:
        registry.stop_all()
    preds = np.concatenate([first.labels, second.labels])
    acc = float((preds == ds.test_labels).mean())
    return SmokeResult(
        models=(model0, model1), engines=(engine0, engine1), probe=probe, accuracy=acc,
        fit_s=(fit0, fit1), served=(first, second), queued_at_reload=queued,
        metrics=batcher.metrics.snapshot(),
    )


def run_smoke(args) -> int:
    r = smoke(args)
    n = len(r.labels)
    _print_stats(args.encoder, r.metrics, n, sum(s.wall_s for s in r.served))
    print(f"served accuracy over {n} requests: {r.accuracy:.4f}")
    print("smoke OK")
    return 0


def run_serve(args) -> int:
    """Serve an existing checkpoint against a synthetic request stream."""
    registry = ModelRegistry()
    try:
        batcher = registry.register_checkpoint(
            "uhd", args.ckpt, batch_size=args.batch, devices=[torch.device(args.device)],
            start=True,
        )
        engine = registry.engine("uhd")
        print(f"engine loaded: {engine.describe()}")
        rng = np.random.default_rng(0)
        stream = rng.uniform(
            0, 255, (args.requests, engine.model.cfg.n_features)
        ).astype(np.float32)
        served = _serve_stream(registry, "uhd", stream)
    finally:
        registry.stop_all()
    _print_stats("uhd", batcher.metrics.snapshot(), len(stream), served.wall_s)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="full train -> checkpoint -> load -> serve loop")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (serve target, or smoke output)")
    ap.add_argument("--dataset", default="synth_mnist")
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--n-train", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32,
                    help="static serving batch (slot count)")
    ap.add_argument("--encoder", default="uhd",
                    help="registered encoder (uhd | uhd_dynamic | baseline)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the kernels run on cuda, the plain versions on cpu")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.smoke:
        return run_smoke(args)
    if not args.ckpt:
        ap.error("--ckpt is required unless --smoke")
    return run_serve(args)


if __name__ == "__main__":
    raise SystemExit(main())
