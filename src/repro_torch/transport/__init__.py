"""repro_torch.transport — network front-end + lifecycle watcher (the port of ``repro.transport``).

Turns the `repro_torch.serving` library into a service: `HdcHttpServer`
exposes a `ModelRegistry` over HTTP/1.1 (JSON control plane, raw
little-endian binary hot path, bounded-queue admission control),
`HdcClient` is its stdlib client, and `ReloadWatcher` closes the
checkpoint-promotion loop by polling `CheckpointManager.poll_latest`
in the background — including auto-promoting `convert`-ed
table -> `uhd_dynamic` checkpoints so a fleet migrates to the small
codebook without restarts.  The wire formats are the JAX package's,
byte for byte.

    registry = ModelRegistry()
    registry.register_checkpoint("uhd", "ckpt/", start=True)
    ReloadWatcher(registry, "uhd", interval_s=2.0).start()
    server = HdcHttpServer(registry, port=8000).start()
    ...
    server.stop()          # stop accepting, drain in-flight connections
    registry.shutdown()    # watchers -> batcher drain -> engine release

CLI driver: ``python -m repro_torch.launch.serve_http --smoke``.
"""

from repro_torch.transport import protocol  # noqa: F401
from repro_torch.transport.client import HdcClient, OverloadedError, TransportError  # noqa: F401
from repro_torch.transport.server import HdcHttpServer  # noqa: F401
from repro_torch.transport.watcher import ReloadWatcher  # noqa: F401
