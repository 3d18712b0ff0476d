"""HTTP serving driver: train -> publish -> serve over a real socket.

    PYTHONPATH=src python -m repro_torch.launch.serve_http --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_http --smoke --device cpu

The torch counterpart of ``repro.launch.serve_http``: the packed
serving stack of `repro_torch.serving`, fronted by `repro_torch.transport`
— an `HdcHttpServer` on a real TCP socket, `HdcClient` workers
generating traffic, and a `ReloadWatcher` doing the checkpoint
promotion.  On a card each engine's step is a CUDA graph, and the
watcher captures the promoted engine's graph on its own thread while
the stream is served.

`--smoke` runs the full production shape end to end:

  1. train an `HDCModel`, publish checkpoint step 0, register it and
     start the drain thread + reload watcher + HTTP server;
  2. verify transport parity: labels over HTTP (JSON single and raw
     binary batch) are bit-identical to the in-process engine, and a
     raw ``:search?k=3`` of the same images has those labels in column 0;
  3. stream requests from concurrent client threads; **mid-traffic**
     the trainer publishes step 1 — the `convert`-ed table ->
     `uhd_dynamic` artifact of the same model state — and the watcher
     promotes it with requests in flight (the stream repeats until a pass
     has begun after the promotion).  Because conversion is exact,
     every label of the stream must still match the step-0 engine
     bit-for-bit, whichever side of the swap served it;
  4. exercise the admission-control edges (413 oversize payload) and
     the `/metrics` + `/healthz` control plane;
  5. drain shutdown: server stops accepting and drains in-flight
     connections, then the registry stops watcher -> batcher -> engine.

`--replicas N` (with optional `--placement`) deploys the entry as a
replica fleet: the smoke then additionally asserts pool
health/placement reporting, per-replica Prometheus series, and that the
mid-traffic promotion swaps every replica atomically.  On `--device
cuda` the replicas are planned over every visible card (one card: each
replica pins it); on `--device cpu` over the CPU.  Sharded replicas
need several devices per replica: plan them with
``ModelRegistry.register_checkpoint(..., devices=[...])``.

Serving an existing checkpoint directory (watcher follows the trainer):

    PYTHONPATH=src python -m repro_torch.launch.serve_http --ckpt /path/to/ckpt
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.core import HDCConfig, HDCModel
from repro_torch.data import load_dataset
from repro_torch.serving import ModelRegistry, ServingEngine
from repro_torch.transport import HdcClient, HdcHttpServer, ReloadWatcher, TransportError


def _stream_over_http(
    host: str,
    port: int,
    name: str,
    images: np.ndarray,
    *,
    workers: int = 4,
    chunk: int = 8,
) -> np.ndarray:
    """Push images through concurrent clients (one keep-alive connection
    per worker, binary hot path); returns labels in input order."""
    out = np.full(len(images), -1, np.int32)

    def worker(start: int) -> None:
        with HdcClient(host, port, timeout_s=120.0) as client:
            for i in range(start, len(images), workers * chunk):
                block = images[i : i + chunk]
                out[i : i + len(block)] = client.predict_batch(name, block)

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        list(pool.map(worker, [w * chunk for w in range(workers)]))
    assert (out >= 0).all(), "stream left unserved requests"
    return out


def _entry_snapshot(batcher) -> dict:
    """Metrics snapshot for a registry entry: fleet-merged for a
    `ReplicaPool`, the batcher's own for a single engine."""
    merged = getattr(batcher, "merged_metrics", None)
    return (merged() if merged is not None else batcher.metrics).snapshot()


def _engines(batcher) -> list[ServingEngine]:
    """The entry's live engines: every replica's for a pool."""
    replicas = getattr(batcher, "replicas", None)
    return [r.engine for r in replicas] if replicas is not None else [batcher.engine]


@dataclasses.dataclass
class SmokeResult:
    model: HDCModel  # the trained model of step 0 (step 1 is its convert)
    engine0: ServingEngine  # the step-0 engine (replica 0's for a pool)
    engines: list[ServingEngine]  # the promoted step-1 engines, one per replica
    probe: np.ndarray  # the parity check's images
    probe_labels: np.ndarray  # their labels over HTTP (raw binary)
    search: tuple[np.ndarray, np.ndarray]  # raw :search?k=3 of the probe
    labels: np.ndarray  # the stream's first pass's labels, in request order
    accuracy: float
    n_passes: int  # passes over the stream (the last began after the promotion)
    serve_s: float  # the stream's wall seconds, every pass
    steps_served: dict  # checkpoint step -> request spans it served (trace ring)
    metrics: dict  # the entry's snapshot after the stream (fleet-merged for a pool)
    health: dict  # /healthz's entry for the model
    prometheus: str  # the text exposition after the stream


def smoke(args) -> SmokeResult:
    device = torch.device(args.device)
    ds = load_dataset(args.dataset, n_train=args.n_train, n_test=args.requests)
    cfg = HDCConfig(
        n_features=ds.n_features, n_classes=ds.n_classes, d=args.d,
        levels=args.levels, encoder=args.encoder, backend=args.backend,
    )
    name = args.encoder
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="hdc_serve_http_smoke_")

    # -- 1: train + publish step 0, bring the service up ------------------
    t0 = time.time()
    model = HDCModel.create(cfg, device=device).fit(ds.train_images, ds.train_labels)
    model.save(ckpt_dir, step=0)
    print(f"trained {len(ds.train_images)} images + checkpointed step 0 "
          f"({time.time()-t0:.1f}s) -> {ckpt_dir}")

    registry = ModelRegistry(trace_jsonl=args.trace_jsonl)
    server = None
    try:
        batcher = registry.register_checkpoint(
            name, ckpt_dir, step=0, batch_size=args.batch,
            placement=args.placement, replicas=args.replicas,
            devices=None if args.device == "cuda" else ["cpu"],  # every visible card
            max_depth=args.max_queue_depth, start=True,
        )
        engine0 = registry.engine(name)
        entry_desc = registry.describe_entry(name)
        print(f"placement: {entry_desc['placement']}"
              + (f" x{entry_desc['n_replicas']} replicas"
                 if "n_replicas" in entry_desc else ""))
        watcher = ReloadWatcher(
            registry, name, interval_s=args.watch_interval,
            on_promote=lambda n, s: print(f"[watcher] promoted {n!r} to step {s}"),
        ).start()
        server = HdcHttpServer(
            registry, host=args.host, port=args.port,
            max_body_bytes=args.max_body_bytes,
            enable_profiling=args.enable_profiling,
        ).start()
        host, port = server.address
        print(f"serving {engine0.describe()}")
        print(f"listening on http://{host}:{port} "
              f"(watcher interval {args.watch_interval}s)")

        # -- 2: transport parity against the in-process engine ------------
        with HdcClient(host, port) as client:
            assert client.healthz()["status"] == "ok"
            probe = np.asarray(ds.test_images[: args.batch], np.float32)
            direct = engine0.predict(probe)
            via_json = np.asarray([client.predict(name, img) for img in probe[:4]])
            via_bin = client.predict_batch(name, probe)
            assert np.array_equal(via_json, direct[:4]), "JSON path diverged"
            assert np.array_equal(via_bin, direct), "binary path diverged"
            k = min(3, ds.n_classes)
            search = client.search(name, probe, k=k)
            assert np.array_equal(search[0][:, 0], via_bin), "search column 0 != predict"
            want = engine0.search(probe, k)
            assert all(np.array_equal(g, w) for g, w in zip(search, want)), \
                "search diverged from the in-process engine"
            print(f"transport parity vs in-process engine: OK ({len(probe)} images; "
                  "search k=3 equals the engine's, column 0 the labels)")

            # 413: oversize payloads are refused before they are buffered
            try:
                client.predict_batch(
                    name,
                    np.zeros((args.max_body_bytes // (4 * ds.n_features) + 2,
                              ds.n_features), np.float32),
                )
                raise AssertionError("oversize payload was not refused")
            except TransportError as e:
                assert e.status == 413, e
                print("admission control: oversize payload -> 413 OK")

        # -- 3: stream with a watcher-driven table->dynamic promotion -----
        # when roughly half of the stream has been served the trainer
        # publishes step 1 — the exact `convert`-ed table -> uhd_dynamic
        # representation — and the watcher promotes it with requests in
        # flight; every label must match the step-0 engine bit-for-bit.
        # The stream repeats until one pass has started after the
        # promotion, so the swap lands mid-traffic however fast a pass is
        # and the promoted engine serves a whole pass.
        n_before = _entry_snapshot(batcher)["n_requests"]
        half = len(ds.test_images) // 2
        passes: list[np.ndarray] = []
        promoted_evt = threading.Event()

        def traffic() -> None:
            while True:
                after = promoted_evt.is_set()
                passes.append(_stream_over_http(host, port, name, ds.test_images))
                if after:
                    return

        t_serve0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as stream_pool:
            stream_fut = stream_pool.submit(traffic)
            while (_entry_snapshot(batcher)["n_requests"] - n_before < half
                   and not stream_fut.done()):
                time.sleep(0.001)

            table_bytes = int(engine0.describe()["codebook_bytes"])
            model.convert("uhd_dynamic").save(ckpt_dir, step=1)
            print("published step 1 (uhd_dynamic convert of the same state) "
                  "with the stream in flight")
            deadline = time.time() + max(30.0, 50 * args.watch_interval)
            while registry.engine(name).step != 1:
                if time.time() > deadline or stream_fut.done():
                    stream_fut.result()  # a failed stream raises its own error
                    raise AssertionError("watcher did not promote step 1 in time")
                time.sleep(args.watch_interval / 4)
            promoted_evt.set()
            promoted = registry.engine(name)
            print(f"watcher promoted mid-traffic: step {promoted.step}, "
                  f"encoder {promoted.model.cfg.encoder!r}, codebook "
                  f"{table_bytes} -> {promoted.describe()['codebook_bytes']} bytes")
            stream_fut.result()
        serve_wall = time.perf_counter() - t_serve0

        # bit-identical across the whole stream, both sides of the promotion
        reference = np.asarray(engine0.predict(ds.test_images))
        for preds in passes:
            assert np.array_equal(preds, reference), \
                "labels diverged across the table->dynamic promotion"
        preds = passes[0]
        acc = float((preds == ds.test_labels).mean())

        # -- 4: control plane reflects what happened ----------------------
        with HdcClient(host, port) as client:
            snap = client.metrics()[name]
            health = client.healthz()["models"][name]
            trace_entries = client.traces()
            prom = client.metrics(prometheus=True)
        assert snap["n_reloads"] >= 1, snap
        assert health["step"] == 1 and health["watcher"]["n_promotions"] >= 1

        if args.replicas > 1:
            # the promotion was atomic over the whole fleet: every replica
            # is at step 1, and the control plane reports the fleet shape
            assert health["placement"] == "pool", health
            assert [r["replica"] for r in health["replicas"]] == list(
                range(args.replicas)
            ), health
            assert all(r["step"] == 1 for r in health["replicas"]), health
            assert all(e.step == 1 for e in _engines(registry.batcher(name)))
            print(f"fleet: all {args.replicas} replicas at step 1 after the "
                  "mid-traffic promotion (atomic swap) OK")

        # every streamed request left a trace whose four spans are
        # disjoint sub-intervals of [submit, done]
        req_traces = [t for t in trace_entries if t["kind"] == "request"]
        assert len(req_traces) >= min(args.requests, 1024), len(req_traces)
        for t in req_traces:
            spans = t["spans"]
            assert set(spans) == {"queue_ms", "assembly_ms", "device_ms",
                                  "write_ms"}, spans
            assert sum(spans.values()) <= t["e2e_ms"] + 1e-6, t
        promo_events = [t for t in trace_entries
                        if t["kind"] == "event" and t["event"] == "promotion"]
        assert promo_events and promo_events[-1]["step"] == 1, promo_events
        assert "uhd_requests_total" in prom, prom[:200]
        assert "uhd_stage_latency_seconds_bucket" in prom, prom[:200]
        if args.replicas > 1:
            # pool entries break the uhd_* families out per replica
            assert 'replica="pool"' in prom and 'replica="0"' in prom, prom[:400]
        print(f"traces: {len(req_traces)} request spans + {len(promo_events)} "
              "promotion events, span sums <= e2e: OK")
        print(f"prometheus exposition: {len(prom.splitlines())} lines OK")
        if args.trace_jsonl:
            print(f"trace JSONL streamed to {args.trace_jsonl}")
        engines = _engines(registry.batcher(name))

        # -- 5: drain shutdown ---------------------------------------------
        server.stop()
        server = None
        registry.shutdown()
        assert not watcher.running()
    finally:
        if server is not None:
            server.stop(drain=False)
        registry.shutdown(drain=False)
    return SmokeResult(
        model=model, engine0=engine0, engines=engines, probe=probe,
        probe_labels=via_bin, search=search, labels=preds, accuracy=acc,
        n_passes=len(passes), serve_s=serve_wall,
        steps_served=dict(collections.Counter(t["step"] for t in req_traces)),
        metrics=snap, health=health, prometheus=prom,
    )


def run_smoke(args) -> int:
    r = smoke(args)
    snap, n = r.metrics, r.n_passes * len(r.labels)
    print(
        f"[{args.encoder}] served {n} HTTP requests ({r.n_passes} passes) in {r.serve_s:.2f}s: "
        f"{n / r.serve_s:.1f} img/s | latency p50 {snap['p50_ms']:.2f}ms "
        f"p99 {snap['p99_ms']:.2f}ms | {snap['n_batches']} batches, "
        f"occupancy {snap['batch_occupancy']:.2f}, reloads {snap['n_reloads']}, "
        f"shed {snap['n_shed']}, errors {snap['n_errors']}"
    )
    print(f"served accuracy over {len(r.labels)} requests: {r.accuracy:.4f}")
    print("smoke OK")
    return 0


def run_serve(args) -> int:
    """Serve an existing checkpoint dir over HTTP until interrupted; the
    watcher follows whatever steps the trainer publishes there."""
    registry = ModelRegistry(trace_jsonl=args.trace_jsonl)
    server = None
    try:
        registry.register_checkpoint(
            args.name, args.ckpt, batch_size=args.batch,
            placement=args.placement, replicas=args.replicas,
            devices=None if args.device == "cuda" else ["cpu"],  # every visible card
            max_depth=args.max_queue_depth, start=True,
        )
        print(f"placement: {registry.describe_entry(args.name)['placement']}")
        watcher = ReloadWatcher(
            registry, args.name, interval_s=args.watch_interval,
            on_promote=lambda n, s: print(f"[watcher] promoted {n!r} to step {s}"),
        ).start()
        server = HdcHttpServer(
            registry, host=args.host, port=args.port,
            max_body_bytes=args.max_body_bytes,
            enable_profiling=args.enable_profiling,
        ).start()
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
    assert not watcher.running()
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="train -> publish -> serve over a socket -> "
                         "watcher-driven promotion -> drain shutdown")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (serve target, or smoke output)")
    ap.add_argument("--name", default="uhd", help="served model name")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral)")
    ap.add_argument("--dataset", default="synth_mnist")
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--n-train", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32,
                    help="static serving batch (slot count)")
    ap.add_argument("--encoder", default="uhd",
                    help="registered encoder (uhd | uhd_dynamic | baseline)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the kernels run on cuda, the plain versions on cpu")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the model name (a "
                         "ReplicaPool with least-loaded dispatch)")
    ap.add_argument("--placement", default="auto",
                    help="execution placement per replica: auto | device "
                         "| sharded (D-sharded predict over the replica's "
                         "device group)")
    ap.add_argument("--watch-interval", type=float, default=0.2,
                    help="reload watcher poll interval (seconds)")
    ap.add_argument("--max-queue-depth", type=int, default=1024,
                    help="admission bound: queued requests before 429")
    ap.add_argument("--max-body-bytes", type=int, default=4 << 20,
                    help="admission bound: request payload before 413")
    ap.add_argument("--trace-jsonl", default=None,
                    help="stream finished trace entries to this JSONL file")
    ap.add_argument("--enable-profiling", action="store_true",
                    help="allow POST /v1/debug/profile (torch.profiler "
                         "capture); off by default")
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
