"""Fleet observability driver: aggregate N serving endpoints.

    PYTHONPATH=src python -m repro_torch.launch.obs_agg --smoke
    PYTHONPATH=src python -m repro_torch.launch.obs_agg --smoke --device cpu

The torch counterpart of ``repro.launch.obs_agg``.  `--smoke` stands up
the whole §13 plane end to end, in one process but over real TCP
sockets, with both serving endpoints planned over every visible card
(`--device cuda`, the default) or on the CPU (`--device cpu`):

  1. train an `HDCModel`, publish a checkpoint, and start TWO serving
     endpoints — one a 2-replica `ReplicaPool`, one a single engine —
     each behind its own `HdcHttpServer` socket;
  2. start a `FleetAggregator` scraping both on an interval, plus its
     `AggregatorServer` front-end;
  3. drive traffic through `HdcClient`s and assert the tentpole
     invariants:
       * the aggregator's merged histograms are **bit-identical** to a
         manual `ServingMetrics.from_state(...).merge(...)` over the
         targets' own ``/metrics?detail=state`` responses;
       * a client-minted request id (sent as ``x-hdc-request-id``,
         adopted by the server) resolves at the **aggregator's**
         ``/v1/traces?id=`` to a single trace carrying the pool
         replica that served it;
       * the windowed series derive a positive request rate from
         cumulative deltas;
       * the aggregator's Prometheus exposition survives the strict
         `parse_exposition` audit (HELP/TYPE once per family);
  4. kill one target mid-run: ``/v1/fleet`` marks it stale (with the
     scrape error), the survivor stays fresh, and the merged view still
     serves — a dead target degrades, never crashes the plane.

Aggregating existing endpoints until interrupted:

    PYTHONPATH=src python -m repro_torch.launch.obs_agg \\
        --target 127.0.0.1:8081 --target 127.0.0.1:8082 --port 9100
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.core import HDCConfig, HDCModel
from repro_torch.data import load_dataset
from repro_torch.obs.aggregator import AggregatorServer, FleetAggregator, HttpTarget
from repro_torch.obs.prometheus import parse_exposition
from repro_torch.serving import ModelRegistry
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.transport import HdcClient, HdcHttpServer, TransportError


def _wait_for_cycles(agg: FleetAggregator, n: int, timeout_s: float = 30.0):
    """Block until the aggregator has completed >= n scrape cycles."""
    deadline = time.time() + timeout_s
    while agg.fleet()["n_cycles"] < n:
        if time.time() > deadline:
            raise AssertionError(
                f"aggregator did not reach {n} cycles within {timeout_s}s"
            )
        time.sleep(agg.interval_s / 4)


def smoke(args) -> dict:
    """The smoke's steps; returns what it checked, for the caller to report."""
    device = torch.device(args.device)
    ds = load_dataset(args.dataset, n_train=args.n_train, n_test=args.requests)
    cfg = HDCConfig(
        n_features=ds.n_features, n_classes=ds.n_classes, d=args.d,
        levels=args.levels, encoder="uhd", backend=args.backend,
    )
    name = "uhd"
    ckpt_dir = tempfile.mkdtemp(prefix="hdc_obs_agg_smoke_")

    # -- 1: one model, two serving endpoints over real sockets ------------
    t0 = time.time()
    HDCModel.create(cfg, device=device).fit(ds.train_images, ds.train_labels).save(
        ckpt_dir, step=0
    )
    print(f"trained + checkpointed step 0 ({time.time()-t0:.1f}s)")

    registries, servers, engines = [], [], []
    for replicas in (2, 1):  # endpoint 0 is a pool, endpoint 1 a single
        registry = ModelRegistry()
        registry.register_checkpoint(
            name, ckpt_dir, step=0, batch_size=args.batch, replicas=replicas,
            devices=None if device.type == "cuda" else ["cpu"],  # every visible card
            start=True, max_delay_ms=0.5,
        )
        registries.append(registry)
        batcher = registry.batcher(name)
        engines += [r.engine for r in getattr(batcher, "replicas", [batcher])]
        servers.append(HdcHttpServer(registry, host=args.host).start())
    (host_a, port_a), (host_b, port_b) = (s.address for s in servers)
    print(f"serving: pool x2 on :{port_a}, single on :{port_b}")

    # -- 2: the plane -----------------------------------------------------
    agg = FleetAggregator(
        [
            HttpTarget(host_a, port_a, name="pool"),
            HttpTarget(host_b, port_b, name="single"),
        ],
        interval_s=args.interval, slo_ms=args.slo_ms,
    ).start()
    front = AggregatorServer(agg, host=args.host, port=args.port).start()
    print(f"aggregator scraping 2 targets every {agg.interval_s}s, "
          f"serving on http://{front.host}:{front.port}")

    try:
        # -- 3: traffic + tentpole invariants -----------------------------
        rid = None
        with HdcClient(host_a, port_a) as ca, HdcClient(host_b, port_b) as cb:
            for i in range(0, len(ds.test_images), args.batch):
                block = ds.test_images[i : i + args.batch]
                ca.predict_batch(name, block)
                cb.predict_batch(name, block[: max(1, len(block) // 2)])
            # one single-image request whose client-minted id we follow
            # across hops: client -> pool server -> replica -> aggregator
            ca.predict(name, ds.test_images[0])
            rid = ca.last_request_id
        assert rid is not None and rid.startswith("cli-"), rid
        print(f"streamed {len(ds.test_images)} images per endpoint; "
              f"tracked id {rid}")

        cycles = agg.fleet()["n_cycles"]
        _wait_for_cycles(agg, cycles + 2)

        # merged histograms: traffic has stopped and the aggregator has
        # completed fresh cycles, so its merged view must be
        # BIT-IDENTICAL to a manual from_state+merge over the targets'
        # own ``?detail=state`` responses (the tentpole exactness claim)
        with HdcClient(host_a, port_a) as ca, HdcClient(host_b, port_b) as cb:
            state_a = ca.metrics_state()[name]["serving"]
            state_b = cb.metrics_state()[name]["serving"]
        manual = ServingMetrics.from_state(state_a).merge(
            ServingMetrics.from_state(state_b)
        )
        fleet_state = agg.merged_state()[name]["serving"]
        assert fleet_state == manual.state(), (
            "aggregator merge skewed from manual Histogram.merge"
        )
        merged = agg.merged_metrics()[name]
        assert merged.latency.count == manual.latency.count
        assert merged.n_requests > 0
        print(f"merged fleet view: {merged.n_requests} requests, "
              f"latency count {merged.latency.count} "
              f"(bit-identical to manual state merge)")

        # cross-hop trace: the client-minted id resolves AT THE
        # AGGREGATOR with pool replica attribution
        with HdcClient(front.host, front.port) as cf:
            entry = cf.traces(request_id=rid)
            assert len(entry) == 1, entry
            (entry,) = entry
            assert entry["id"] == rid
            assert entry["target"] == "pool", entry
            assert entry["replica"] in (0, 1), entry
            assert set(entry["spans"]) == {
                "queue_ms", "assembly_ms", "device_ms", "write_ms"
            }
            print(f"cross-hop trace OK: {rid} served by pool replica "
                  f"{entry['replica']}, resolved fleet-wide")

            # unknown id at the aggregator: 404, not an empty 200
            try:
                cf.traces(request_id="req-nope")
                raise AssertionError("unknown id did not 404")
            except TransportError as e:
                assert e.status == 404, e

            # windowed series: a positive request rate derived from
            # cumulative deltas
            fleet = cf._json("GET", "/v1/fleet")
            series = fleet["windows"][name]
            assert series["n_snapshots"] >= 2, series
            assert series["request_rate_rps"] is not None
            assert fleet["n_stale"] == 0, fleet
            print(f"window: {series['n_snapshots']} snapshots over "
                  f"{series['span_s']:.2f}s, rate "
                  f"{series['request_rate_rps']:.1f} rps, "
                  f"slo_burn {series['slo_burn']}")

            # the merged Prometheus exposition survives the strict parse
            prom = cf.metrics(prometheus=True)
        types, helps, samples = parse_exposition(prom)
        assert "uhd_request_latency_seconds" in types
        assert any(n == "uhd_fleet_target_up" for n, _, _ in samples)
        print(f"aggregator exposition: {len(samples)} samples, "
              f"{len(types)} families, HELP/TYPE-once audit OK")

        # -- 4: kill one target; the plane degrades, never crashes --------
        servers[1].stop()
        registries[1].shutdown()
        print("killed target 'single' mid-run")
        deadline = time.time() + max(30.0, 20 * agg.interval_s)
        while True:
            fleet = agg.fleet()
            by_name = {t["name"]: t for t in fleet["targets"]}
            if by_name["single"]["stale"] and not by_name["pool"]["stale"]:
                break
            if time.time() > deadline:
                raise AssertionError(f"staleness not detected: {fleet}")
            time.sleep(agg.interval_s / 2)
        assert by_name["single"]["last_error"], by_name["single"]
        assert fleet["n_stale"] == 1, fleet

        # the survivor's merged metrics still serve and still advance
        before = agg.merged_metrics()[name].n_requests
        with HdcClient(host_a, port_a) as ca:
            ca.predict_batch(name, ds.test_images[: args.batch])
        cycles = agg.fleet()["n_cycles"]
        _wait_for_cycles(agg, cycles + 2)
        after = agg.merged_metrics()[name].n_requests
        assert after > before, (before, after)
        with HdcClient(front.host, front.port) as cf:
            assert cf.healthz()["status"] == "ok"
        print(f"degraded cleanly: 'single' stale "
              f"(err: {by_name['single']['last_error'][:60]}...), "
              f"survivor advanced {before} -> {after} merged requests")
    finally:
        front.stop()
        agg.stop()
        for s in servers:
            try:
                s.stop()
            except Exception:
                pass
        for r in registries:
            r.shutdown()
    return {
        "merged_requests": merged.n_requests,
        "merged_latency_count": merged.latency.count,
        "tracked_id": rid,
        "tracked_replica": entry["replica"],
        "window_snapshots": series["n_snapshots"],
        "request_rate_rps": series["request_rate_rps"],
        "exposition_samples": len(samples),
        "exposition_families": len(types),
        "stale_error": by_name["single"]["last_error"],
        "survivor_requests": [before, after],
        "graph_replays": sum(e.n_replays for e in engines),
        "engines": [
            {"execution": d["execution"], "graph": d["graph"], "n_replays": d["n_replays"]}
            for d in (e.describe() for e in engines)
        ],
    }


def run_smoke(args) -> int:
    smoke(args)
    print("smoke OK")
    return 0


def run_aggregate(args) -> int:
    """Aggregate the given endpoints until interrupted."""
    targets = []
    for spec in args.target:
        host, _, port = spec.rpartition(":")
        targets.append(HttpTarget(host or "127.0.0.1", int(port)))
    if not targets:
        raise SystemExit("at least one --target host:port is required")
    agg = FleetAggregator(
        targets, interval_s=args.interval, slo_ms=args.slo_ms
    ).start()
    front = AggregatorServer(agg, host=args.host, port=args.port).start()
    print(f"aggregating {len(targets)} targets every {agg.interval_s}s on "
          f"http://{front.host}:{front.port} — Ctrl-C to stop")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        front.stop()
        agg.stop()
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="two live endpoints -> aggregator -> merged view, "
                         "cross-hop trace, staleness degradation")
    ap.add_argument("--target", action="append", default=[],
                    help="endpoint host:port to scrape (repeatable)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="aggregator TCP port (0 = ephemeral)")
    ap.add_argument("--interval", type=float, default=0.2,
                    help="scrape interval (seconds)")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="latency objective for the SLO-burn series")
    ap.add_argument("--dataset", default="synth_mnist")
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the kernels run on cuda, the plain versions on cpu")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    if args.smoke:
        return run_smoke(args)
    return run_aggregate(args)


if __name__ == "__main__":
    raise SystemExit(main())
