"""Online-learning driver: serve, ingest feedback, improve mid-traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve_online --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_online --smoke --device cpu

The torch counterpart of ``repro.launch.serve_online``: the closed loop
of DESIGN.md §10 run end to end as one process — the packed serving
stack (`repro_torch.serving` + `repro_torch.transport`) in front, an
`OnlineLearner` behind it consuming `POST :feedback` traffic on its own
CUDA stream, and the `ReloadWatcher` promoting the learner's published
checkpoints (capturing each new engine's graph) with requests in flight.

`--smoke` asserts the production shape:

  1. train a deliberately-small *base* model, publish step 0, bring up
     batcher + learner + watcher + HTTP server;
  2. measure held-out accuracy of the base model over HTTP;
  3. stream labeled feedback over the socket (raw binary hot path)
     while predict traffic keeps flowing; the learner drains, trains
     through the fused ``fit_bundle`` kernels, and publishes; the
     watcher promotes mid-traffic;
  4. exactness: the promoted engine's class sums are **bit-identical**
     to offline ``partial_fit`` of the same feedback stream on the base
     model (HDC's additive updates — the paper's "dynamic" claim);
  5. held-out accuracy after the loop must improve on the base model;
  6. drain shutdown: server, then learner -> watcher -> batcher ->
     engine via `ModelRegistry.shutdown()` (the order is checked).

Serving an existing checkpoint directory with online learning enabled:

    PYTHONPATH=src python -m repro_torch.launch.serve_online --ckpt /path/to/ckpt
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
from repro_torch.online import OnlineLearner
from repro_torch.serving import ModelRegistry
from repro_torch.transport import HdcClient, HdcHttpServer, ReloadWatcher


def _predict_all(client: HdcClient, name: str, images, chunk: int = 64) -> np.ndarray:
    out = []
    for i in range(0, len(images), chunk):
        out.append(client.predict_batch(name, images[i : i + chunk]))
    return np.concatenate(out)


def _record_stop(obj, order: list[str], tag: str) -> None:
    """Wrap obj.stop to append `tag` to `order` when it is called."""
    stop = obj.stop

    def recorded(*a, **kw):
        order.append(tag)
        return stop(*a, **kw)

    obj.stop = recorded


@dataclasses.dataclass
class SmokeResult:
    offline: HDCModel  # base.partial_fit of the whole feedback stream
    promoted_sums: np.ndarray  # the promoted engine's (C, D) int32 class sums
    promoted_step: int
    acc_before: float
    acc_after: float
    ingest_s: float  # wall seconds of the feedback stream over HTTP
    online: dict  # the learner's snapshot (`/metrics`' "online")
    metrics: dict  # the entry's serving snapshot after the loop
    health: dict  # /healthz's entry for the model
    shutdown_order: list[str]  # stop calls in order during shutdown
    graph_replays: int  # graph replays of the engines that served (0 on the CPU)


def smoke(args) -> SmokeResult:
    device = torch.device(args.device)
    n_total = args.n_base + args.n_feedback
    ds = load_dataset(args.dataset, n_train=n_total, n_test=args.requests)
    base_x, base_y = ds.train_images[: args.n_base], ds.train_labels[: args.n_base]
    feed_x = np.asarray(ds.train_images[args.n_base :], np.float32)
    feed_y = np.asarray(ds.train_labels[args.n_base :], np.int32)
    cfg = HDCConfig(
        n_features=ds.n_features, n_classes=ds.n_classes, d=args.d,
        levels=args.levels, encoder=args.encoder, backend=args.backend,
    )
    name = args.encoder
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="hdc_serve_online_smoke_")

    # -- 1: base model + the full online stack ----------------------------
    t0 = time.time()
    base = HDCModel.create(cfg, device=device).fit(base_x, base_y)
    base.save(ckpt_dir, step=0)
    print(f"trained base on {args.n_base} images + checkpointed step 0 "
          f"({time.time()-t0:.1f}s) -> {ckpt_dir}")

    registry = ModelRegistry()
    server = None
    engines = []  # every engine that served, for the replay count

    def promoted(n: str, s: int) -> None:
        engines.append(registry.engine(n))
        print(f"[watcher] promoted {n!r} to step {s}")

    try:
        batcher = registry.register_checkpoint(
            name, ckpt_dir, step=0, batch_size=args.batch,
            devices=None if device.type == "cuda" else ["cpu"],  # every visible card
            max_depth=args.max_queue_depth, start=True,
        )
        learner = OnlineLearner(
            registry, name, train_batch=args.train_batch,
            publish_every_s=args.publish_interval, poll_interval_s=0.01,
            keep_n=args.keep_n,
            on_publish=lambda n, s: print(f"[learner] published step {s}"),
        ).start()
        watcher = ReloadWatcher(
            registry, name, interval_s=args.watch_interval, on_promote=promoted,
        ).start()
        engines.append(batcher.engine)
        server = HdcHttpServer(registry).start()
        host, port = server.address
        print(f"serving {registry.engine(name).describe()}")
        print(f"listening on http://{host}:{port} (learner publish every "
              f"{args.publish_interval}s, watcher poll {args.watch_interval}s)")

        # -- 2: held-out accuracy before any feedback ---------------------
        with HdcClient(host, port, timeout_s=120.0) as client:
            assert client.healthz()["models"][name]["learner"]["n_ingested"] == 0
            acc_before = float(
                (_predict_all(client, name, ds.test_images) == ds.test_labels).mean()
            )
            print(f"held-out accuracy, base model ({args.n_base} examples): "
                  f"{acc_before:.4f}")

            # -- 3: stream feedback + predict traffic concurrently --------
            t_feed = time.perf_counter()
            n_chunks = 0
            for i in range(0, len(feed_x), args.feedback_chunk):
                client.feedback(
                    name, feed_x[i : i + args.feedback_chunk],
                    feed_y[i : i + args.feedback_chunk],
                )
                n_chunks += 1
                if n_chunks % 4 == 0:  # predict path stays live mid-ingest
                    client.predict_batch(name, ds.test_images[: args.batch])
            ingest_wall = time.perf_counter() - t_feed
            print(f"streamed {len(feed_x)} feedback examples in {n_chunks} chunks "
                  f"({len(feed_x)/ingest_wall:.0f} ex/s over HTTP)")

            # -- 4: wait for the promoted engine to contain everything ----
            expect_n = args.n_base + len(feed_x)
            deadline = time.time() + max(60.0, 100 * args.watch_interval)
            while registry.engine(name).model.n_examples != expect_n:
                if time.time() > deadline:
                    raise AssertionError(
                        f"promotion did not converge: engine has "
                        f"{registry.engine(name).model.n_examples} of {expect_n} "
                        f"examples; learner {learner.snapshot()}"
                    )
                time.sleep(args.watch_interval / 4)
            promoted = registry.engine(name)
            promoted_sums = promoted.model.class_sums.cpu().numpy()
            offline = base.partial_fit(feed_x, feed_y)
            assert np.array_equal(offline.class_sums.cpu().numpy(), promoted_sums), \
                "promoted class sums diverged from offline partial_fit"
            print(f"promoted step {promoted.step} is bit-identical to offline "
                  f"partial_fit on the same {len(feed_x)}-example stream")

            # -- 5: held-out accuracy after the loop ----------------------
            acc_after = float(
                (_predict_all(client, name, ds.test_images) == ds.test_labels).mean()
            )
            snap = client.metrics()[name]
            health = client.healthz()["models"][name]
        print(f"held-out accuracy, after {len(feed_x)} feedback examples: "
              f"{acc_after:.4f} (base {acc_before:.4f})")
        assert acc_after > acc_before, (
            f"online learning did not improve held-out accuracy: "
            f"{acc_before:.4f} -> {acc_after:.4f}"
        )
        online = snap["online"]
        assert online["n_trained"] == len(feed_x) and online["n_shed"] == 0, online
        assert online["n_published"] >= 1 and snap["n_reloads"] >= 1
        assert health["step"] == promoted.step
        assert health["watcher"]["n_promotions"] >= 1

        # -- 6: drain shutdown ---------------------------------------------
        server.stop()
        server = None
        order: list[str] = []
        _record_stop(learner, order, "learner")
        _record_stop(watcher, order, "watcher")
        _record_stop(registry.batcher(name), order, "batcher")
        registry.shutdown()
        assert order == ["learner", "watcher", "batcher"], order
        assert not learner.running() and not watcher.running()
    finally:
        if server is not None:
            server.stop(drain=False)
        registry.shutdown(drain=False)
    print(
        f"[{name}] online loop OK: {online['n_ingested']} ingested, "
        f"{online['n_trained']} trained, {online['n_published']} published, "
        f"{health['watcher']['n_promotions']} promotions, "
        f"accuracy {acc_before:.4f} -> {acc_after:.4f}, "
        f"predict p99 {snap['p99_ms']:.2f}ms with the learner active"
    )
    return SmokeResult(
        offline=offline, promoted_sums=promoted_sums,
        promoted_step=int(promoted.step), acc_before=acc_before, acc_after=acc_after,
        ingest_s=ingest_wall, online=online, metrics=snap, health=health,
        shutdown_order=order, graph_replays=sum(e.n_replays for e in engines),
    )


def run_smoke(args) -> int:
    smoke(args)
    print("smoke OK")
    return 0


def run_serve(args) -> int:
    """Serve an existing checkpoint dir with the online loop attached;
    the learner publishes into the same directory the watcher follows."""
    registry = ModelRegistry()
    server = None
    try:
        registry.register_checkpoint(
            args.name, args.ckpt, batch_size=args.batch,
            devices=None if args.device == "cuda" else ["cpu"],  # every visible card
            max_depth=args.max_queue_depth,
            start=True,
        )
        learner = OnlineLearner(
            registry, args.name, train_batch=args.train_batch,
            publish_every_s=args.publish_interval, keep_n=args.keep_n,
            on_publish=lambda n, s: print(f"[learner] published step {s}"),
        ).start()
        watcher = ReloadWatcher(
            registry, args.name, interval_s=args.watch_interval,
            on_promote=lambda n, s: print(f"[watcher] promoted {n!r} to step {s}"),
        ).start()
        server = HdcHttpServer(registry, host=args.host, port=args.port).start()
        print(f"serving {registry.engine(args.name).describe()}")
        print(f"listening on http://{server.host}:{server.port} — Ctrl-C to stop")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            print("draining...")
    finally:
        if server is not None:
            server.stop()
        registry.shutdown()
    assert not learner.running() and not watcher.running()
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="base model -> serve -> HTTP feedback -> learner "
                         "publish -> watcher promotion -> accuracy improves")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (serve target, or smoke output)")
    ap.add_argument("--name", default="uhd", help="served model name")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--dataset", default="synth_mnist")
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--n-base", type=int, default=256,
                    help="examples in the base (offline) model")
    ap.add_argument("--n-feedback", type=int, default=1024,
                    help="labeled examples streamed over :feedback")
    ap.add_argument("--requests", type=int, default=256,
                    help="held-out examples evaluated over HTTP")
    ap.add_argument("--batch", type=int, default=32,
                    help="static serving batch (slot count)")
    ap.add_argument("--train-batch", type=int, default=256,
                    help="learner training chunk (one kernel shape in steady state)")
    ap.add_argument("--feedback-chunk", type=int, default=128,
                    help="examples per feedback POST")
    ap.add_argument("--encoder", default="uhd",
                    help="registered encoder (uhd | uhd_dynamic | baseline)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the kernels run on cuda, the plain versions on cpu")
    ap.add_argument("--watch-interval", type=float, default=0.1,
                    help="reload watcher poll interval (seconds)")
    ap.add_argument("--publish-interval", type=float, default=0.25,
                    help="learner checkpoint publish interval (seconds)")
    ap.add_argument("--keep-n", type=int, default=4,
                    help="checkpoint retention for learner publishes")
    ap.add_argument("--max-queue-depth", type=int, default=1024)
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
