from repro_torch.data.images import ImageDataset, load_dataset, make_synthetic  # noqa: F401
