"""Observability walk-through: traces, histograms, Prometheus.

Stand up the serving stack, push traffic through it, then read back
everything the instrumentation layer recorded:

  * `/metrics` as JSON: counters plus per-stage latency histograms;
  * `/metrics` with `Accept: text/plain`: the same numbers as Prometheus
    text exposition, ready for a stock scraper;
  * `/v1/traces`: the per-request span ring (queue/assembly/device/write
    sub-intervals of each request's life) and lifecycle events.

    PYTHONPATH=src python -m repro_torch.examples.scrape_metrics              # on the card
    PYTHONPATH=src python -m repro_torch.examples.scrape_metrics --device cpu

The port of ``examples/scrape_metrics.py``, with its sizes and printed
lines.
"""

from __future__ import annotations

import argparse
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core import HDCConfig, HDCModel, resolve_device
    from repro_torch.data import load_dataset
    from repro_torch.serving import ModelRegistry
    from repro_torch.transport import HdcClient, HdcHttpServer

    dev = resolve_device(args.device)

    # 1. train, serve, and push some traffic through the socket
    ds = load_dataset("mnist", n_train=1024, n_test=96)
    cfg = HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=2048)
    model = HDCModel.create(cfg, device=dev).fit(ds.train_images, ds.train_labels)
    ckpt = tempfile.mkdtemp(prefix="hdc_example_obs_")
    model.save(ckpt, step=0)

    registry = ModelRegistry()
    registry.register_checkpoint("mnist", ckpt, batch_size=32, start=True, devices=[dev])
    server = HdcHttpServer(registry).start()

    with HdcClient(*server.address) as client:
        for img in ds.test_images[:32]:
            client.predict("mnist", img)
        client.predict_batch("mnist", ds.test_images[32:])

        # 2. JSON metrics: counters + the per-stage histogram snapshots
        snap = client.metrics()["mnist"]
        print(f"requests={snap['n_requests']} batches={snap['n_batches']} "
              f"p50={snap['p50_ms']:.2f}ms p99={snap['p99_ms']:.2f}ms")
        for stage, s in snap["stages"].items():
            if s["count"]:
                print(f"  stage {stage:<9} n={s['count']:<4} "
                      f"p50={s['p50_ms']:.3f}ms p99={s['p99_ms']:.3f}ms")

        # 3. the same numbers as Prometheus text exposition: point a real
        #    scraper at GET /metrics with Accept: text/plain
        prom = client.metrics(prometheus=True)
        wanted = ("uhd_requests_total", "uhd_queue_depth",
                  "uhd_request_latency_seconds_count")
        print("\nprometheus exposition (excerpt):")
        for line in prom.splitlines():
            if line.startswith(wanted):
                print(" ", line)

        # 4. per-request traces: each entry is one request's life broken
        #    into disjoint spans, so the spans always sum to <= e2e
        traces = client.traces(n=3, kind="request")
        print("\nlast 3 request traces:")
        for t in traces:
            spans = " ".join(f"{k.removesuffix('_ms')}={v:.3f}"
                             for k, v in t["spans"].items())
            print(f"  {t['id']} e2e={t['e2e_ms']:.3f}ms  {spans}")
            assert sum(t["spans"].values()) <= t["e2e_ms"] + 1e-6

    server.stop()
    registry.shutdown()
    print("\ndrained and shut down")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
