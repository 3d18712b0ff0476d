"""Fleet dashboard: poll the aggregator's `/v1/fleet`.

Stand up two serving endpoints (one a 2-replica pool), point a
`FleetAggregator` + `AggregatorServer` at them, stream traffic, and poll
``GET /v1/fleet`` the way a dashboard would, rendering per-target
freshness and the windowed time series (request rate, queue-depth slope,
SLO burn) that the plane derives from cumulative deltas.  Then kill one
endpoint and watch it degrade to stale while the survivor's numbers keep
flowing.

    PYTHONPATH=src python -m repro_torch.examples.fleet_dashboard              # on the card
    PYTHONPATH=src python -m repro_torch.examples.fleet_dashboard --device cpu

The port of ``examples/fleet_dashboard.py``, with its sizes and printed
lines.  Both endpoints serve on the one device given (the pool's two
replicas share it).
"""

from __future__ import annotations

import argparse
import tempfile
import time


def render(fleet: dict) -> None:
    """One dashboard frame from a `/v1/fleet` response."""
    print(f"\n-- fleet @ {fleet['n_cycles']} cycles "
          f"({fleet['n_stale']}/{fleet['n_targets']} stale, "
          f"{fleet['n_traces']} traces merged) --")
    for t in fleet["targets"]:
        age = t["last_scrape_age_s"]
        mark = "STALE" if t["stale"] else "up   "
        age_s = "never" if age is None else f"{age * 1e3:6.0f}ms ago"
        err = f"  last error: {t['last_error']}" if t["last_error"] else ""
        print(f"  [{mark}] {t['name']:<8} scrapes={t['n_scrapes']:<4} "
              f"errors={t['n_errors']:<3} last ok {age_s}{err}")
    for name, s in fleet["windows"].items():
        if s["request_rate_rps"] is None:
            continue
        slope = s["queue_depth_dps"]
        trend = "falling behind" if slope > 1 else (
            "draining" if slope < -1 else "steady")
        burn = "-" if s["slo_burn"] is None else f"{s['slo_burn']:.1%}"
        print(f"  model {name}: {s['request_rate_rps']:7.1f} req/s over "
              f"{s['span_s']:.1f}s window, shed {s['shed_rate_rps']:.1f}/s, "
              f"queue {s['queue_depth']} ({trend}), slo burn {burn}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core import HDCConfig, HDCModel, resolve_device
    from repro_torch.data import load_dataset
    from repro_torch.obs.aggregator import AggregatorServer, FleetAggregator, HttpTarget
    from repro_torch.serving import ModelRegistry
    from repro_torch.transport import HdcClient, HdcHttpServer

    dev = resolve_device(args.device)

    # 1. one trained model behind two endpoints: a 2-replica pool + a single
    ds = load_dataset("synth_mnist", n_train=1024, n_test=256)
    cfg = HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=1024)
    ckpt = tempfile.mkdtemp(prefix="hdc_example_fleet_")
    HDCModel.create(cfg, device=dev).fit(ds.train_images, ds.train_labels).save(ckpt, step=0)

    registries, servers = [], []
    for replicas in (2, 1):
        registry = ModelRegistry()
        registry.register_checkpoint("mnist", ckpt, batch_size=32, replicas=replicas,
                                     start=True, devices=[dev])
        registries.append(registry)
        servers.append(HdcHttpServer(registry).start())

    # 2. the plane: scrape both every 100ms, serve the merged view
    agg = FleetAggregator(
        [HttpTarget(*servers[0].address, name="pool"),
         HttpTarget(*servers[1].address, name="single")],
        interval_s=0.1,
    ).start()
    front = AggregatorServer(agg).start()
    print(f"aggregator on http://{front.host}:{front.port} "
          f"(merged /metrics, /v1/traces, /v1/fleet)")

    with HdcClient(*front.address) as dash:
        # 3. stream traffic and poll /v1/fleet like a dashboard refresh
        for _ in range(3):
            with HdcClient(*servers[0].address) as ca, \
                    HdcClient(*servers[1].address) as cb:
                for i in range(0, len(ds.test_images), 32):
                    ca.predict_batch("mnist", ds.test_images[i : i + 32])
                    cb.predict_batch("mnist", ds.test_images[i : i + 16])
            time.sleep(0.25)  # let a couple of scrape cycles land
            render(dash._json("GET", "/v1/fleet"))

        # 4. any replica's request resolves fleet-wide, attribution intact
        with HdcClient(*servers[0].address) as ca:
            ca.predict("mnist", ds.test_images[0])
            rid = ca.last_request_id
        time.sleep(0.3)
        (trace,) = dash.traces(request_id=rid)
        print(f"\ntrace {rid}: served by target {trace['target']!r} "
              f"replica {trace['replica']}, e2e {trace['e2e_ms']:.2f}ms")

        # 5. kill the single endpoint; the dashboard shows the degradation
        servers[1].stop()
        registries[1].shutdown()
        print("\nkilled target 'single'; waiting for staleness...")
        while True:
            fleet = dash._json("GET", "/v1/fleet")
            if fleet["n_stale"]:
                break
            time.sleep(0.1)
        render(fleet)

    front.stop()
    agg.stop()
    servers[0].stop()
    registries[0].shutdown()
    print("\ndone")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
