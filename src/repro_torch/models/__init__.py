"""The LM model stack for the assigned architectures, in PyTorch: the
torch counterpart of ``repro.models`` (serving path: forward, prefill and
decode; training waits for the optimizer and step)."""
