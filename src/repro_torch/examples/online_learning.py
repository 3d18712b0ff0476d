"""Close the serving loop: learn from feedback traffic.

Serve a deliberately under-trained model, POST labeled feedback to it
over HTTP while predict traffic flows, and watch the background learner
train + publish and the watcher promote the improved model: no restart,
no offline retrain, and the promoted state is bit-identical to offline
`partial_fit` on the same feedback stream.

    PYTHONPATH=src python -m repro_torch.examples.online_learning              # on the card
    PYTHONPATH=src python -m repro_torch.examples.online_learning --device cpu

The port of ``examples/online_learning.py``, with its sizes and printed
lines.  On a card the learner trains through the fused ``fit_bundle``
kernel on a CUDA stream of its own.
"""

from __future__ import annotations

import argparse
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core import HDCConfig, HDCModel, resolve_device
    from repro_torch.data import load_dataset
    from repro_torch.online import OnlineLearner
    from repro_torch.serving import ModelRegistry
    from repro_torch.transport import HdcClient, HdcHttpServer, ReloadWatcher

    dev = resolve_device(args.device)

    # 1. a weak base model: 256 training examples, checkpointed as step 0
    ds = load_dataset("mnist", n_train=256 + 2048, n_test=256)
    cfg = HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=2048)
    base = HDCModel.create(cfg, device=dev).fit(ds.train_images[:256], ds.train_labels[:256])
    ckpt = tempfile.mkdtemp(prefix="hdc_example_online_")
    base.save(ckpt, step=0)

    # 2. the full loop: batcher + learner + watcher + HTTP server
    registry = ModelRegistry()
    registry.register_checkpoint("mnist", ckpt, batch_size=32, start=True, devices=[dev])
    OnlineLearner(registry, "mnist", train_batch=256, publish_every_s=0.5, keep_n=3).start()
    ReloadWatcher(registry, "mnist", interval_s=0.1).start()
    server = HdcHttpServer(registry).start()
    host, port = server.address
    print(f"serving on http://{host}:{port}")

    with HdcClient(host, port) as client:
        labels = client.predict_batch("mnist", ds.test_images)
        print(f"base accuracy (256 examples): "
              f"{(labels == ds.test_labels).mean():.4f}")

        # 3. stream labeled feedback over the raw binary hot path; predict
        #    traffic keeps flowing against whatever step is currently live
        feed_x = np.asarray(ds.train_images[256:], np.float32)
        feed_y = np.asarray(ds.train_labels[256:], np.int32)
        for i in range(0, len(feed_x), 128):
            ack = client.feedback("mnist", feed_x[i:i + 128], feed_y[i:i + 128])
            client.predict_batch("mnist", ds.test_images[:32])
        print(f"streamed {len(feed_x)} feedback examples "
              f"(last ack: {ack})")

        # 4. wait for the learner->watcher loop to promote everything
        expect = base.n_examples + len(feed_x)
        while registry.engine("mnist").model.n_examples != expect:
            time.sleep(0.1)
        online = client.metrics()["mnist"]["online"]
        print(f"learner: trained {online['n_trained']}, published "
              f"{online['n_published']} checkpoints, shed {online['n_shed']}")

        # 5. the promoted model is exactly offline partial_fit on the stream
        promoted = registry.engine("mnist").model
        offline = base.partial_fit(feed_x, feed_y)
        same = np.array_equal(promoted.class_sums.cpu().numpy(),
                              offline.class_sums.cpu().numpy())
        labels = client.predict_batch("mnist", ds.test_images)
        print(f"promoted step {registry.engine('mnist').step}: accuracy "
              f"{(labels == ds.test_labels).mean():.4f}, bit-identical to "
              f"offline partial_fit: {same}")

    server.stop()
    registry.shutdown()  # learner (drain+final publish) -> watcher -> batcher
    print("drained and shut down")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
