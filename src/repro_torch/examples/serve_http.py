"""Serve an HDC classifier over HTTP in ~40 lines.

Train -> checkpoint -> serve on a real socket -> query with the stdlib
client -> publish a converted table-free checkpoint and watch the
background watcher promote it without a restart.

    PYTHONPATH=src python -m repro_torch.examples.serve_http              # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_http --device cpu

The port of ``examples/serve_http.py``, with its sizes and printed
lines.  The engine serves on the one device given (on a card its
predict step is a CUDA graph over the encode and top-k kernels).  To
keep learning from labeled traffic after deployment see
`repro_torch.examples.online_learning`; to scale the same entry to a
replica fleet pass ``replicas=N`` (and ``placement=``) to
`register_checkpoint`, or run ``python -m repro_torch.launch.serve_http
--smoke --replicas 4``.
"""

from __future__ import annotations

import argparse
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core import HDCConfig, HDCModel, resolve_device
    from repro_torch.data import load_dataset
    from repro_torch.serving import ModelRegistry
    from repro_torch.transport import HdcClient, HdcHttpServer, ReloadWatcher

    dev = resolve_device(args.device)

    # 1. train and publish checkpoint step 0 (the table-encoder artifact)
    ds = load_dataset("mnist", n_train=1024, n_test=64)
    cfg = HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=2048)
    model = HDCModel.create(cfg, device=dev).fit(ds.train_images, ds.train_labels)
    ckpt = tempfile.mkdtemp(prefix="hdc_example_http_")
    model.save(ckpt, step=0)

    # 2. bring the service up: registry + drain thread + watcher + HTTP server
    registry = ModelRegistry()
    registry.register_checkpoint("mnist", ckpt, batch_size=32, start=True, devices=[dev])
    watcher = ReloadWatcher(registry, "mnist", interval_s=0.2).start()
    server = HdcHttpServer(registry).start()
    host, port = server.address
    print(f"serving on http://{host}:{port}")

    # 3. query it like any other inference service
    with HdcClient(host, port) as client:
        print("healthz:", client.healthz()["status"])
        info = client.models()["mnist"]
        print(f"model: encoder={info['encoder']} d={info['d']} "
              f"codebook={info['codebook_bytes']} bytes")
        labels = client.predict_batch("mnist", ds.test_images)  # binary hot path
        acc = (labels == ds.test_labels).mean()
        print(f"served accuracy over {len(labels)} HTTP requests: {acc:.4f}")

        # 4. fleet migration with no restart: publish the convert-ed
        #    table-free artifact; the watcher promotes it in the background
        model.convert("uhd_dynamic").save(ckpt, step=1)
        while client.healthz()["models"]["mnist"]["step"] != 1:
            time.sleep(0.1)
        info = client.models()["mnist"]
        print(f"watcher promoted step 1: encoder={info['encoder']} "
              f"codebook={info['codebook_bytes']} bytes (same labels: "
              f"{bool((client.predict_batch('mnist', ds.test_images) == labels).all())})")

    server.stop()
    registry.shutdown()  # watcher -> batcher drain -> engine release
    print("drained and shut down")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
