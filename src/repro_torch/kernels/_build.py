"""Build the CUDA kernels once per process and bind them with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch
headers), so each compiles in seconds.  :func:`library` compiles every
``.cu`` file with its own ``nvcc`` process, all started together, for
``sm_90a``; links them into one shared library under
``build/repro_torch/<hash of the sources and flags>/``; and loads it.
A second call, or a later process that finds the library for the same
sources, reuses it.  Nothing here runs at import time: this module is
imported on machines with no CUDA toolkit, and only the first kernel
launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *ARCH]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C entry points and their argument types (see the sources).
SIGNATURES = {
    "uhd_encode_bundle": (_P, _P, _I, _P, _I, _I, _I, _P),
    "uhd_fit_bundle": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _P),
    "uhd_fit_bundle_hist": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "uhd_encode_bundle_dynamic": (_P, _P, _I, _P, _I, _I, _I, _L, _P),
    "uhd_fit_bundle_dynamic": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _L, _P),
    "uhd_fit_bundle_dynamic_hist": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P),
    "uhd_hamming_topk": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "uhd_hamming_topk_scratch": (_I, _I, _I, _I),
    "uhd_hamming_packed": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    "uhd_encode_unary_mxu": (_P, _P, _I, _I, _I, _I, _P, _P),
    "uhd_encode_unary_mxu_wide": (_I, _I),
    "uhd_bundle_binarize": (_P, _P, _I, _I, _I, _I, _P, _P),
    "uhd_bundle_binarize_cluster": (_I, _I, _I, _I),
}
_RESTYPES = {"uhd_hamming_topk_scratch": _L}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build in this process printed and took (chip_smoke reports it)
build_info: dict = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, PATH or /usr/local/cuda/bin; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of repro_torch are built from source with nvcc"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> Path:
    """Compile every source in parallel, then link one shared library."""
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, objs = {}, []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs[src.name] = out
        if proc.returncode != 0:
            for _, _, other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        objs.append(str(obj))
    lib = out_dir / "libuhd_kernels.so"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", *objs, "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    build_info.update(seconds=time.perf_counter() - t0, logs=logs, cached=False)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        final = BUILD_ROOT / source_hash()
        lib_path = final / "libuhd_kernels.so"
        if not lib_path.is_file():
            nvcc = find_nvcc()
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_ROOT / f"{final.name}.tmp{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            _compile(nvcc, tmp)
            try:
                tmp.rename(final)  # atomic publish; a concurrent process may win
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            build_info.update(seconds=0.0, logs={}, cached=True)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _lib = lib
        return lib
