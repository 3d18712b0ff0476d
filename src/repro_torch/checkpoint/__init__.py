from repro_torch.checkpoint.manager import CheckpointManager, install_sigterm_handler  # noqa: F401
