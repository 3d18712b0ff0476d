from repro_torch.analysis import roofline  # noqa: F401
