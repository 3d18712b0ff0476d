"""Public wrappers of the port's CUDA kernels.

Each wrapper chooses by the device of the tensors it is given, and by
nothing else: a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the hand-written
kernel (built on first use by :mod:`repro_torch.kernels._build`) or the
call raises.  There is no fallback from one to the other.

``LAUNCHES`` counts, per wrapper, the calls that launched its kernel,
and ``LAUNCH_SHAPES`` the same calls by the shape they ran at (a short
``"B=64 H=784 D=8192 ..."`` key), and ``LAUNCH_CARDS`` by the index of
the card they ran on; ``chip_smoke.py`` zeroes them before
driving each path and reads them after, to show that the path ran
through the kernels and to price each shape's launches.  One call of
``hamming_topk`` is one launch on its warp path, else one scan launch
plus its merge passes (:func:`topk_path`), one call of
``hamming_packed`` one launch per 1,048,560 rows on either path
(:func:`packed_path`), and one call of ``fit_bundle`` or
``fit_bundle_dynamic`` on its histogram path a histogram and a gather
launch; each counts as one.  A kernel captured into a CUDA graph
counts once at each replay of the graph, not at the capture
(:func:`recording`, :func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref

LAUNCHES: dict[str, int] = {
    "encode_bundle": 0,
    "fit_bundle": 0,
    "encode_bundle_dynamic": 0,
    "fit_bundle_dynamic": 0,
    "hamming_topk": 0,
    "hamming_packed": 0,
    "encode_unary_mxu": 0,
    "bundle_binarize": 0,
}
LAUNCH_SHAPES: dict[str, dict[str, int]] = {name: {} for name in LAUNCHES}
LAUNCH_CARDS: dict[str, dict[int, int]] = {name: {} for name in LAUNCHES}

#: grid-dimension limits of the kernels (the encodes' grid runs 64-row tiles along z,
#: the direct training step 128-row tiles along y, each at most 65535; kernel 7's grid
#: runs B along x, which has room for any int32 B, and D / 64 tiles along y)
_MAX_ENCODE_ROWS = 65535 * 64
_MAX_MXU_COLS = 65535 * 64
_MAX_FIT_ROWS = 65535 * 128
#: the histogram form of fit_bundle and fit_bundle_dynamic: each feature's thresholds span
#: at most 256 values (int8 table entries, uint8 direction entries), a histogram block holds
#: (4, 257, C rounded up to 4) int32 counts in shared memory (at most 48 classes), and G,
#: (H, 256, C rounded up to 4) int32, is scratch
HIST_MAX_CLASSES = 48
HIST_MAX_SCRATCH_BYTES = 256 * 2**20
_DIR_DTYPES = (torch.uint8, torch.uint16, torch.uint32)
#: kernel 5's paths (``topk_path``): stores of at most this many rows take the warp
#: path (one warp a query, no merge), larger ones the tensor-core path; the codes are
#: the kernel's
TOPK_WARP_MAX_ROWS = 64
_TOPK_PATHS = {"warp": 0, "tensor": 1}
#: kernel 6's paths (``packed_path``): stores of at most this many rows take the warp
#: path (one warp a query), larger ones the tensor-core path; the codes are the kernel's
PACKED_WARP_MAX_ROWS = 64
_PACKED_PATHS = {"warp": 0, "tensor": 1}
_TABLE_DTYPES = (torch.int8, torch.int32)


_count_lock = threading.Lock()
_capturing = threading.local()


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            LAUNCH_SHAPES[name].clear()
            LAUNCH_CARDS[name].clear()


def add_launches(launches: list[tuple[str, str, int]]) -> None:
    """Count launches given as (wrapper name, shape key, card index)
    triples: the kernels a CUDA graph replay runs (see :func:`recording`)."""
    with _count_lock:
        for name, key, card in launches:
            LAUNCHES[name] += 1
            LAUNCH_SHAPES[name][key] = LAUNCH_SHAPES[name].get(key, 0) + 1
            LAUNCH_CARDS[name][card] = LAUNCH_CARDS[name].get(card, 0) + 1


@contextlib.contextmanager
def recording():
    """Collect this thread's launches as (name, shape key) pairs instead of
    counting them: under a CUDA graph capture a wrapper's kernel is
    recorded into the graph, not run, and runs at each replay, which
    counts the list with :func:`add_launches`."""
    launches: list[tuple[str, str, int]] = []
    _capturing.launches = launches
    try:
        yield launches
    finally:
        _capturing.launches = None


def _launched(name: str, dev: torch.device, **dims) -> None:
    key = " ".join(f"{k}={v}" for k, v in dims.items())
    launch = (name, key, torch.cuda.current_device() if dev.index is None else dev.index)
    captured = getattr(_capturing, "launches", None)
    if captured is not None:
        captured.append(launch)
    else:
        add_launches([launch])


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors; CUDA tensors must share one device; any other
    device is refused."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"repro_torch kernels run on cuda or cpu tensors, got {dev}")
    return False


def _check(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh copy of it where a view's offset leaves its base off a
    16-byte boundary (a TMA tensor map needs one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _direction_args(x: torch.Tensor, direction: torch.Tensor):
    if x.dim() != 2:
        raise ValueError(f"x_q must be (B, H), got {tuple(x.shape)}")
    if direction.shape != (x.shape[1], 32):
        raise ValueError(
            f"direction must be (H, 32) = ({x.shape[1]}, 32), got {tuple(direction.shape)}"
        )
    if direction.dtype not in _DIR_DTYPES:
        raise ValueError(f"direction dtype {direction.dtype} not in {_DIR_DTYPES}")
    return direction.contiguous(), direction.element_size()


def _table_args(x: torch.Tensor, sobol_q: torch.Tensor):
    if x.dim() != 2:
        raise ValueError(f"x_q must be (B, H), got {tuple(x.shape)}")
    if sobol_q.dim() != 2 or sobol_q.shape[0] != x.shape[1]:
        raise ValueError(
            f"sobol_q must be (H, D) with H = {x.shape[1]}, got {tuple(sobol_q.shape)}"
        )
    if sobol_q.dtype not in _TABLE_DTYPES:
        raise ValueError(f"sobol_q dtype {sobol_q.dtype} not in {_TABLE_DTYPES}")
    return sobol_q.contiguous(), sobol_q.element_size()


def _packed_args(q_words: torch.Tensor, c_words: torch.Tensor):
    if q_words.dtype != torch.int32 or c_words.dtype != torch.int32:
        raise ValueError("packed words must be int32 bit patterns")
    if q_words.dim() != 2 or c_words.dim() != 2 or q_words.shape[1] != c_words.shape[1]:
        raise ValueError(
            f"expected (B, W) and (C, W) words, got {tuple(q_words.shape)} and "
            f"{tuple(c_words.shape)}"
        )
    return q_words.contiguous(), c_words.contiguous()


def encode_bundle(x_q: torch.Tensor, sobol_q: torch.Tensor) -> torch.Tensor:
    """Encode+bundle over a stored threshold table, (B, H) int, (H, D)
    int8 or int32 -> (B, D) int32; the kernel (the encode body that
    ``encode_bundle_dynamic`` runs too) reads the table in its stored
    width.  Semantics: ``ref.encode_bundle``."""
    if _on_cpu(x_q, sobol_q):
        return ref.encode_bundle(x_q, sobol_q)
    x = x_q.to(torch.int32).contiguous()
    tab, tab_bytes = _table_args(x, sobol_q)
    b, h = x.shape
    d = tab.shape[1]
    if b > _MAX_ENCODE_ROWS:
        raise ValueError(f"encode_bundle takes at most {_MAX_ENCODE_ROWS} rows, got {b}")
    out = torch.empty((b, d), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().uhd_encode_bundle(
            _ptr(x), _ptr(tab), tab_bytes, _ptr(out), b, h, d, _stream(x.device)
        )
    _check(err, "encode_bundle")
    _launched("encode_bundle", x.device, B=b, H=h, D=d, table=_dtype_name(tab))
    return out


def _hist_fits(n_features: int, n_classes: int) -> bool:
    cp = -(-n_classes // 4) * 4
    return 0 < n_classes <= HIST_MAX_CLASSES and n_features * 256 * cp * 4 <= HIST_MAX_SCRATCH_BYTES


def _hist_scratch(h: int, n_classes: int, dev: torch.device):
    """The histogram form's scratch: G (H, 256, C rounded up to 4), n_c (C,)
    and the span word (zeroed), all int32."""
    cp = -(-n_classes // 4) * 4
    return (torch.empty((h, 256, cp), dtype=torch.int32, device=dev),
            torch.empty(n_classes, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def fit_table_path(table_dtype: torch.dtype, n_features: int, n_classes: int) -> str:
    """Which form of the table training kernel runs, from dtypes and
    shapes alone: ``"histogram"`` (class sums from per-class threshold
    histograms, each feature bucketed over its row's [min, max]) for an
    int8 table, at most ``HIST_MAX_CLASSES`` classes and a histogram
    scratch within ``HIST_MAX_SCRATCH_BYTES``; else ``"direct"`` (the
    compare-and-count kernel).  Both give the same integers."""
    return "histogram" if table_dtype == torch.int8 and _hist_fits(n_features, n_classes) \
        else "direct"


def fit_bundle(
    x_q: torch.Tensor, sobol_q: torch.Tensor, labels: torch.Tensor, n_classes: int
) -> torch.Tensor:
    """Fused training step over a stored threshold table, (B, H), (H, D)
    int8 or int32, (B,) -> (C, D) int32 class sums; labels outside
    [0, n_classes) contribute nothing.  On a card it runs the histogram
    form or the direct form, as :func:`fit_table_path` says.
    Semantics: ``ref.fit_bundle``."""
    if _on_cpu(x_q, sobol_q, labels):
        return ref.fit_bundle(x_q, sobol_q, labels, n_classes)
    x = x_q.to(torch.int32).contiguous()
    tab, tab_bytes = _table_args(x, sobol_q)
    lab = labels.to(torch.int32).contiguous()
    b, h = x.shape
    d = tab.shape[1]
    if lab.shape != (b,):
        raise ValueError(f"labels must be ({b},), got {tuple(lab.shape)}")
    if b > _MAX_FIT_ROWS:
        raise ValueError(f"fit_bundle takes at most {_MAX_FIT_ROWS} rows, got {b}")
    sums = torch.zeros((n_classes, d), dtype=torch.int32, device=x.device)
    path = fit_table_path(tab.dtype, h, n_classes)
    with torch.cuda.device(x.device):
        if path == "histogram":
            g, ncls, span = _hist_scratch(h, n_classes, x.device)
            lo = torch.empty(h, dtype=torch.int32, device=x.device)
            err = _build.library().uhd_fit_bundle_hist(
                _ptr(x), _ptr(tab), _ptr(lab), _ptr(sums), _ptr(g), _ptr(ncls), _ptr(lo),
                _ptr(span), b, h, n_classes, d, _stream(x.device),
            )
        else:
            err = _build.library().uhd_fit_bundle(
                _ptr(x), _ptr(tab), tab_bytes, _ptr(lab), _ptr(sums), b, h, n_classes, d,
                _stream(x.device),
            )
    _check(err, "fit_bundle")
    _launched("fit_bundle", x.device, B=b, H=h, C=n_classes, D=d, table=_dtype_name(tab),
              path=path)
    return sums


def encode_bundle_dynamic(
    x_q: torch.Tensor, direction: torch.Tensor, d: int, *, skip: int = 1
) -> torch.Tensor:
    """Table-free encode+bundle, (B, H) int, (H, 32) -> (B, d) int32.
    Semantics: ``ref.encode_bundle_dynamic``."""
    if _on_cpu(x_q, direction):
        return ref.encode_bundle_dynamic(x_q, direction, d, skip=skip)
    x = x_q.to(torch.int32).contiguous()
    dirs, dir_bytes = _direction_args(x, direction)
    b, h = x.shape
    if b > _MAX_ENCODE_ROWS:
        raise ValueError(f"encode_bundle_dynamic takes at most {_MAX_ENCODE_ROWS} rows, got {b}")
    out = torch.empty((b, d), dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.uhd_encode_bundle_dynamic(
            _ptr(x), _ptr(dirs), dir_bytes, _ptr(out), b, h, d, int(skip),
            _stream(x.device),
        )
    _check(err, "encode_bundle_dynamic")
    _launched("encode_bundle_dynamic", x.device, B=b, H=h, D=d, dir=_dtype_name(dirs))
    return out


def fit_dynamic_path(direction_dtype: torch.dtype, n_features: int, n_classes: int) -> str:
    """Which form of the table-free training kernel runs, from dtypes and
    shapes alone: ``"histogram"`` (class sums from per-class threshold
    histograms) for a uint8 direction matrix, at most
    ``HIST_MAX_CLASSES`` classes and a histogram scratch within
    ``HIST_MAX_SCRATCH_BYTES``; else ``"direct"`` (the compare-and-count
    kernel).  Both give the same integers."""
    return "histogram" if direction_dtype == torch.uint8 and _hist_fits(n_features, n_classes) \
        else "direct"


def fit_bundle_dynamic(
    x_q: torch.Tensor, direction: torch.Tensor, labels: torch.Tensor,
    n_classes: int, d: int, *, skip: int = 1,
) -> torch.Tensor:
    """Fused table-free training step, (B, H), (H, 32), (B,) -> (C, d)
    int32 class sums; labels outside [0, n_classes) contribute nothing.
    On a card it runs the histogram form or the direct form, as
    :func:`fit_dynamic_path` says.  Semantics: ``ref.fit_bundle_dynamic``."""
    if _on_cpu(x_q, direction, labels):
        return ref.fit_bundle_dynamic(x_q, direction, labels, n_classes, d, skip=skip)
    x = x_q.to(torch.int32).contiguous()
    dirs, dir_bytes = _direction_args(x, direction)
    lab = labels.to(torch.int32).contiguous()
    b, h = x.shape
    if lab.shape != (b,):
        raise ValueError(f"labels must be ({b},), got {tuple(lab.shape)}")
    if b > _MAX_FIT_ROWS:
        raise ValueError(f"fit_bundle_dynamic takes at most {_MAX_FIT_ROWS} rows, got {b}")
    sums = torch.zeros((n_classes, d), dtype=torch.int32, device=x.device)
    path = fit_dynamic_path(dirs.dtype, h, n_classes)
    with torch.cuda.device(x.device):
        if path == "histogram":
            g, ncls, span = _hist_scratch(h, n_classes, x.device)
            err = _build.library().uhd_fit_bundle_dynamic_hist(
                _ptr(x), _ptr(dirs), _ptr(lab), _ptr(sums), _ptr(g), _ptr(ncls),
                _ptr(span), b, h, n_classes, d, int(skip), _stream(x.device),
            )
        else:
            err = _build.library().uhd_fit_bundle_dynamic(
                _ptr(x), _ptr(dirs), dir_bytes, _ptr(lab), _ptr(sums), b, h,
                n_classes, d, int(skip), _stream(x.device),
            )
    _check(err, "fit_bundle_dynamic")
    _launched("fit_bundle_dynamic", x.device, B=b, H=h, C=n_classes, D=d,
              dir=_dtype_name(dirs), path=path)
    return sums


def topk_path(n_rows: int) -> str:
    """Which path of the top-k kernel runs, from the store's row count alone:
    ``"warp"`` for at most ``TOPK_WARP_MAX_ROWS`` rows (one warp a query
    selects k by warp-wide minima: one launch), else ``"tensor"`` (binary
    AND-popcount products on the tensor cores, each block's k best selected
    in its epilogue, then merge passes).  Both take any k in [1, C] and give
    the same result."""
    return "warp" if n_rows <= TOPK_WARP_MAX_ROWS else "tensor"


def hamming_topk(
    q_words: torch.Tensor, c_words: torch.Tensor, d: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed top-k retrieval, (B, W), (C, W) int32 words -> ((B, k) int32
    indices, (B, k) int32 Hamming distances), each row ascending by
    (distance, index), lowest index on ties; any k in [1, C].  On a card
    it runs the path :func:`topk_path` picks.
    ``d`` is not needed for distances (kept for parity with the JAX op).
    Semantics: ``ref.hamming_topk_oracle``."""
    c = c_words.shape[0]
    if not 1 <= k <= c:
        raise ValueError(f"k must be in [1, {c}], got {k}")
    if _on_cpu(q_words, c_words):
        return ref.hamming_topk(q_words, c_words, d, k)
    q, rows = _packed_args(q_words, c_words)
    b, w = q.shape
    dev = q.device
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    dist = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return idx, dist
    lib = _build.library()
    path = topk_path(c)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count  # the split of the store
    n = lib.uhd_hamming_topk_scratch(b, c, k, sms)
    scratch = [torch.empty(n, dtype=torch.int64, device=dev) if n else None for _ in range(2)]
    with torch.cuda.device(dev):
        err = lib.uhd_hamming_topk(
            _ptr(q), _ptr(rows), b, c, w, k, _TOPK_PATHS[path], sms, _ptr(scratch[0]),
            _ptr(scratch[1]), _ptr(idx), _ptr(dist), _stream(dev),
        )
    _check(err, "hamming_topk")
    _launched("hamming_topk", dev, B=b, C=c, W=w, k=k, path=path)
    return idx, dist


def packed_path(n_rows: int) -> str:
    """Which path of the packed-score kernel runs, from the row count alone:
    ``"warp"`` for at most ``PACKED_WARP_MAX_ROWS`` rows (one warp a query,
    every row's loads in flight at once), else ``"tensor"`` (binary
    AND-popcount products on the tensor cores).  Both give the same
    integers."""
    return "warp" if n_rows <= PACKED_WARP_MAX_ROWS else "tensor"


def hamming_packed(q_words: torch.Tensor, c_words: torch.Tensor, d: int) -> torch.Tensor:
    """Packed ±1 similarity, (B, W), (C, W) int32 words -> (B, C) int32
    scores d - 2 * popcount(q ^ c); ``d`` is the length of the packed
    sign vectors (a shard's d_local under D-sharded serving).  On a card
    it runs the path :func:`packed_path` picks.
    Semantics: ``ref.hamming_packed``."""
    if _on_cpu(q_words, c_words):
        return ref.hamming_packed(q_words, c_words, d)
    q, rows = _packed_args(q_words, c_words)
    (b, w), c = q.shape, rows.shape[0]
    out = torch.empty((b, c), dtype=torch.int32, device=q.device)
    if b == 0 or c == 0:
        return out
    path = packed_path(c)
    with torch.cuda.device(q.device):
        err = _build.library().uhd_hamming_packed(
            _ptr(q), _ptr(rows), b, c, w, int(d), _PACKED_PATHS[path], _ptr(out),
            _stream(q.device),
        )
    _check(err, "hamming_packed")
    _launched("hamming_packed", q.device, B=b, C=c, W=w, path=path)
    return out


def encode_unary_mxu_operands(u: torch.Tensor, onehot_t: torch.Tensor, h: int) -> torch.Tensor:
    """Binary contraction with the affine epilogue on the int8 tensor
    cores: (B, K) and (D, K) 0/1 int8 operands, K contiguous in both ->
    (B, D) int32 ``2 * (u @ onehot_t.T) - h``.  A K that is not a
    multiple of 32 is padded with zero columns here (they add nothing);
    the operand builders of ``ref`` pad already.  Semantics:
    ``ref.encode_unary_mxu``."""
    if _on_cpu(u, onehot_t):
        return ref.encode_unary_mxu(u, onehot_t, h)
    if u.dim() != 2 or onehot_t.dim() != 2 or u.shape[1] != onehot_t.shape[1]:
        raise ValueError(
            f"expected (B, K) and (D, K) operands, got {tuple(u.shape)} and "
            f"{tuple(onehot_t.shape)}"
        )
    if u.dtype != torch.int8 or onehot_t.dtype != torch.int8:
        raise ValueError("encode_unary_mxu operands must be int8 0/1")
    (b, k), d = u.shape, onehot_t.shape[0]
    if d > _MAX_MXU_COLS:
        raise ValueError(f"encode_unary_mxu takes at most {_MAX_MXU_COLS} columns, got {d}")
    pad = -k % ref.K_ALIGN
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
        onehot_t = torch.nn.functional.pad(onehot_t, (0, pad))
    # the tensor maps need 16-byte aligned bases: a view's offset may break that
    u, onehot_t = (_aligned16(t.contiguous()) for t in (u, onehot_t))
    out = torch.empty((b, d), dtype=torch.int32, device=u.device)
    if b == 0 or d == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(u.device):
        err = lib.uhd_encode_unary_mxu(
            _ptr(u), _ptr(onehot_t), b, d, k + pad, int(h), _ptr(out), _stream(u.device)
        )
    _check(err, "encode_unary_mxu")
    _launched("encode_unary_mxu", u.device, B=b, K=k + pad, D=d,
              tile="wide" if lib.uhd_encode_unary_mxu_wide(b, d) else "narrow")
    return out


def encode_unary_mxu(x_q: torch.Tensor, sobol_q: torch.Tensor, levels: int) -> torch.Tensor:
    """The uHD table encode as a binary matmul, (B, H) int, (H, D) ->
    (B, D) int32: builds the inclusive thermometer of x and the one-hot
    of the thresholds (``ref.unary_mxu_operands``), then contracts them
    (:func:`encode_unary_mxu_operands`).  Equal to ``encode_bundle``."""
    return encode_unary_mxu_operands(*ref.unary_mxu_operands(x_q, sobol_q, levels))


def bundle_binarize(
    hvs: torch.Tensor, labels: torch.Tensor, n_classes: int, *, binarize: bool = True
) -> torch.Tensor:
    """Class bundling with the fused sign, (B, D) int, (B,) -> (C, D):
    int8 ±1 signs of the per-class sums (ties -> +1) with ``binarize``,
    else the int32 sums.  Labels outside [0, n_classes) are dropped.  On
    a card the batch is split over a thread-block cluster whose size the
    launch key records.  Semantics: ``ref.bundle_binarize`` over
    ``ref.class_onehot``."""
    if _on_cpu(hvs, labels):
        return ref.bundle_binarize(hvs, ref.class_onehot(labels, n_classes), binarize=binarize)
    if hvs.dim() != 2:
        raise ValueError(f"hvs must be (B, D), got {tuple(hvs.shape)}")
    hv = hvs.to(torch.int32).contiguous()
    lab = labels.to(torch.int32).contiguous()
    b, d = hv.shape
    if lab.shape != (b,):
        raise ValueError(f"labels must be ({b},), got {tuple(lab.shape)}")
    out = torch.empty((n_classes, d), dtype=torch.int8 if binarize else torch.int32,
                      device=hv.device)
    lib = _build.library()
    with torch.cuda.device(hv.device):
        err = lib.uhd_bundle_binarize(
            _ptr(hv), _ptr(lab), b, n_classes, d, int(binarize), _ptr(out), _stream(hv.device)
        )
        cluster = lib.uhd_bundle_binarize_cluster(n_classes, d, int(binarize),
                                                  int(hv.data_ptr() % 16 == 0))
    _check(err, "bundle_binarize")
    _launched("bundle_binarize", hv.device, B=b, C=n_classes, D=d, binarize=bool(binarize),
              cluster=cluster)
    return out
