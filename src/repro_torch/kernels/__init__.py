"""Hand-written CUDA kernels of the port, with their plain versions.

``csrc/`` holds the CUDA C++ sources, ``_build.py`` builds and binds
them, ``ops.py`` the wrappers that choose by device, ``ref.py`` the
plain PyTorch versions.
"""
