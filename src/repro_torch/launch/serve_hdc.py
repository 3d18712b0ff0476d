"""HDC inference launcher: train -> checkpoint -> load -> serve, on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve_hdc --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_hdc --smoke --device cpu

The torch counterpart of ``repro.launch.serve_hdc``.  ``--smoke`` trains
on the first half of a synthetic training set, checkpoints step 0, loads
it into a `ServingEngine` (class HVs packed once), checks the packed
path against ``HDCModel.predict(similarity="hamming")``, serves half of
the request stream, trains on the second half with ``partial_fit``,
publishes step 1, swaps in an engine loaded from step 1, and serves the
rest.  Requests are served in static batches of ``--batch`` (the last
one padded).  Prints fit seconds, per-batch latency, img/s and the
served accuracy.

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
from repro_torch.serving import ServingEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServeStats:
    labels: np.ndarray
    batch_s: list[float]  # wall seconds of each static batch, synchronised

    @property
    def wall_s(self) -> float:
        return float(sum(self.batch_s))


def serve_batches(engine: ServingEngine, images: np.ndarray, batch: int) -> ServeStats:
    """Serve `images` in static batches of `batch` rows (the last padded)."""
    labels, times = [], []
    for i in range(0, len(images), batch):
        chunk = images[i : i + batch]
        padded = np.zeros((batch,) + chunk.shape[1:], chunk.dtype)
        padded[: len(chunk)] = chunk
        t0 = time.perf_counter()
        out = engine.predict(padded)
        _sync(engine.model.device)
        times.append(time.perf_counter() - t0)
        labels.append(out[: len(chunk)])
    return ServeStats(np.concatenate(labels).astype(np.int32), times)


@dataclasses.dataclass
class SmokeResult:
    models: tuple[HDCModel, HDCModel]  # the trained models of steps 0 and 1
    engines: tuple[ServingEngine, ServingEngine]
    probe: np.ndarray  # the images of the parity check
    accuracy: float
    fit_s: tuple[float, float]  # fit and partial_fit wall seconds, synchronised
    serve: tuple[ServeStats, ServeStats]


def smoke(args) -> SmokeResult:
    """The whole train -> checkpoint -> load -> serve -> retrain -> reload loop."""
    device = torch.device(args.device)
    ds = load_dataset(args.dataset, n_train=args.n_train, n_test=args.requests)
    cfg = HDCConfig(
        n_features=ds.n_features, n_classes=ds.n_classes, d=args.d,
        levels=args.levels, encoder=args.encoder,
    )
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
    engine0 = ServingEngine.from_checkpoint(ckpt_dir, step=0, batch_size=args.batch, device=device)
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

    # -- serve the first half of the stream -------------------------------
    n1 = len(ds.test_images) // 2
    serve1 = serve_batches(engine0, ds.test_images[:n1], args.batch)

    # -- the trainer publishes step 1; the service swaps engines ----------
    t0 = time.perf_counter()
    model1 = engine0.model.partial_fit(ds.train_images[half:], ds.train_labels[half:])
    _sync(device)
    fit1 = time.perf_counter() - t0
    model1.save(ckpt_dir, step=1)
    engine1 = ServingEngine.from_checkpoint(ckpt_dir, step=1, batch_size=args.batch, device=device)
    print(f"reloaded to step {engine1.step} (n_seen {engine1.model.n_examples}, "
          f"partial_fit {fit1:.3f}s)")

    # -- serve the rest of the stream on the new engine -------------------
    serve2 = serve_batches(engine1, ds.test_images[n1:], args.batch)
    preds = np.concatenate([serve1.labels, serve2.labels])
    acc = float((preds == ds.test_labels).mean())
    return SmokeResult(
        models=(model0, model1), engines=(engine0, engine1), probe=probe,
        accuracy=acc, fit_s=(fit0, fit1), serve=(serve1, serve2),
    )


def _print_stats(n: int, batch_s: list[float]) -> None:
    ms = np.asarray(batch_s) * 1e3
    wall = float(sum(batch_s))
    print(
        f"served {n} requests in {len(ms)} batches, {wall:.4f}s: {n / wall:.1f} img/s | "
        f"batch latency p50 {np.percentile(ms, 50):.3f}ms "
        f"p99 {np.percentile(ms, 99):.3f}ms mean {ms.mean():.3f}ms"
    )


def run_smoke(args) -> int:
    r = smoke(args)
    n = len(r.serve[0].labels) + len(r.serve[1].labels)
    _print_stats(n, r.serve[0].batch_s + r.serve[1].batch_s)
    print(f"served accuracy over {n} requests: {r.accuracy:.4f}")
    print("smoke OK")
    return 0


def run_serve(args) -> int:
    """Serve an existing checkpoint against a synthetic request stream."""
    engine = ServingEngine.from_checkpoint(args.ckpt, batch_size=args.batch, device=args.device)
    print(f"engine loaded: {engine.describe()}")
    rng = np.random.default_rng(0)
    stream = rng.uniform(0, 255, (args.requests, engine.model.cfg.n_features)).astype(np.float32)
    stats = serve_batches(engine, stream, args.batch)
    _print_stats(len(stream), stats.batch_s)
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
    ap.add_argument("--batch", type=int, default=32, help="static serving batch")
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
