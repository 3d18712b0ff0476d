from repro_torch.training.step import make_train_step  # noqa: F401
