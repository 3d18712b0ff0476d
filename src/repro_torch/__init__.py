"""repro_torch — the uHD system on PyTorch and CUDA for an NVIDIA H100.

A port of the JAX package ``repro`` (the reference, left unchanged),
slice by slice; see ROADMAP.md for what is ported.  It imports nothing
of JAX or of ``repro``.  Entry points run on the card unless given
``device="cpu"``.
"""

from repro_torch.core import HDCConfig, HDCModel  # noqa: F401
