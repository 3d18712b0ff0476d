"""repro_torch.online — online learning from serving traffic (the port of ``repro.online``).

Labeled feedback POSTed to the serving front-end (`POST
/v1/models/{name}:feedback`) lands in a bounded `FeedbackBuffer`; an
`OnlineLearner` daemon thread drains it through ``partial_fit`` (the
fused ``fit_bundle`` kernels on a card, on the learner's own CUDA
stream) and periodically publishes checkpoints; the `ReloadWatcher`
promotes them into the serving path with traffic in flight.  HDC's
additive int32 class-sum updates make the learner's state bit-identical
to offline ``partial_fit`` on the same stream, and to the JAX package's
learner.

    registry = ModelRegistry()
    registry.register_checkpoint("uhd", "ckpt/", start=True)
    OnlineLearner(registry, "uhd", publish_every_s=2.0).start()
    ReloadWatcher(registry, "uhd", interval_s=2.0).start()
    server = HdcHttpServer(registry, port=8000).start()
    ...
    server.stop()
    registry.shutdown()   # learners -> watchers -> batcher drain -> engines

CLI driver: ``python -m repro_torch.launch.serve_online --smoke``.
"""

from repro_torch.online.buffer import FeedbackBuffer  # noqa: F401
from repro_torch.online.learner import OnlineLearner  # noqa: F401
