"""The port's kernels against the JAX package, and on the card against
their plain versions.

Inputs are made with numpy from a seed and handed to both packages.
The datapath is integer arithmetic throughout, so every comparison is
**exact equality** (no tolerance).

* On the CPU, ``repro_torch.kernels.ops`` runs the plain versions of
  ``repro_torch.kernels.ref``; they are held against the JAX package's
  Pallas ops (interpret mode on the CPU) and its ``kernels.ref``.
* Tests marked ``cuda`` launch the CUDA kernels and hold each against
  its plain version on the same card; without a card they skip (the
  fixture decides, so every xdist worker collects the same tests).
  Run them on a card with ``python -m pytest -m cuda tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch

from repro_torch.core import sobol as tsobol
from repro_torch.core import unary as tunary
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

try:  # a machine with a card runs the cuda-marked tests alone, and may have no JAX
    import jax.numpy as jnp

    from repro.core import encoding as jenc
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ModuleNotFoundError:
    jnp = jenc = jops = jref = None


@pytest.fixture
def jax_side():
    if jref is None:
        pytest.skip("needs the JAX package")


def _inputs(seed: int, b: int, h: int, levels: int = 16, n_classes: int = 10):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, levels + 1, (b, h)).astype(np.int32)
    labels = rng.integers(0, n_classes, b).astype(np.int32)
    dirs = tsobol.quantized_direction_matrix(h, levels, seed=seed)
    return x, labels, dirs


# (B, H, D, skip, C): every value of each sweep appears at least once
_SHAPES = [
    (1, 49, 300, 0, 2),
    (5, 113, 1000, 1, 10),
    (37, 49, 1000, 1000, 10),
    (37, 113, 300, 1, 2),
]


@pytest.mark.parametrize("b,h,d,skip,c", _SHAPES)
def test_encode_bundle_dynamic_matches_jax(jax_side, b, h, d, skip, c):
    x, _, dirs = _inputs(b * 7 + h, b, h)
    want = np.asarray(jops.encode_bundle_dynamic(jnp.asarray(x), jnp.asarray(dirs), d, skip=skip))
    got = tops.encode_bundle_dynamic(torch.from_numpy(x), torch.from_numpy(dirs), d, skip=skip)
    np.testing.assert_array_equal(got.numpy(), want)
    # the JAX package's pure-jnp datapath agrees too
    np.testing.assert_array_equal(
        np.asarray(jenc.uhd_encode_dynamic(jnp.asarray(x), jnp.asarray(dirs), d, skip=skip)),
        got.numpy(),
    )


@pytest.mark.parametrize("b,h,d,skip,c", _SHAPES)
def test_fit_bundle_dynamic_matches_jax(jax_side, b, h, d, skip, c):
    x, labels, dirs = _inputs(b * 11 + h, b, h, n_classes=c)
    args = (jnp.asarray(x), jnp.asarray(dirs), jnp.asarray(labels), c, d)
    want = np.asarray(jops.fit_bundle_dynamic(*args, skip=skip))
    np.testing.assert_array_equal(np.asarray(jref.fit_bundle_dynamic(*args, skip=skip)), want)
    got = tops.fit_bundle_dynamic(
        torch.from_numpy(x), torch.from_numpy(dirs), torch.from_numpy(labels), c, d, skip=skip
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_fit_bundle_dynamic_drops_out_of_range_labels(jax_side):
    """A label outside [0, C) contributes nothing (the JAX drop contract)."""
    b, h, d, c = 9, 49, 300, 4
    x, _, dirs = _inputs(3, b, h)
    labels = np.asarray([0, -1, 3, c, 2, -7, 1, c + 5, 0], np.int32)
    want = np.asarray(
        jref.fit_bundle_dynamic(
            jnp.asarray(x), jnp.asarray(dirs), jnp.asarray(labels), c, d, skip=1
        )
    )
    got = tref.fit_bundle_dynamic(
        torch.from_numpy(x), torch.from_numpy(dirs), torch.from_numpy(labels), c, d
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.class_onehot(torch.from_numpy(labels), c).numpy(),
        np.asarray(jref.class_onehot(jnp.asarray(labels), c)),
    )
    keep = (labels >= 0) & (labels < c)
    np.testing.assert_array_equal(
        tref.fit_bundle_dynamic(
            torch.from_numpy(x[keep]), torch.from_numpy(dirs),
            torch.from_numpy(labels[keep]), c, d,
        ).numpy(),
        want,
    )


@pytest.mark.parametrize("skip", [0, 1, 1000, 2**32 - 3])
def test_sobol_tile_matches_jax(jax_side, skip):
    dirs = tsobol.direction_matrix(33, seed=1).astype(np.uint32)
    want = np.asarray(jref.sobol_tile(jnp.asarray(dirs), jnp.uint32(skip), 70))
    got = tref.sobol_tile(torch.from_numpy(dirs.view(np.int32)), skip, 70)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _packed_store(seed: int, n_q: int, n_rows: int, d: int):
    """Packed queries and rows with duplicate rows and crafted ties."""
    rng = np.random.default_rng(seed)
    q_bits = rng.random((n_q, d)) < 0.5
    r_bits = rng.random((n_rows, d)) < 0.5
    if n_rows < 5:  # a tiny store: an exact match for query 0, duplicated at the end
        r_bits[0] = r_bits[n_rows - 1] = q_bits[0]
    else:
        r_bits[n_rows // 2] = r_bits[1]  # duplicate rows: equal distances, lowest index wins
        r_bits[n_rows - 1] = r_bits[0]
        r_bits[2] = q_bits[0]  # an exact match for query 0
        flip = r_bits[3].copy()  # rows 3 and 4 at the same distance from query 0
        r_bits[4] = flip
    q = np.asarray(tunary.pack_bits(torch.from_numpy(q_bits)))
    r = np.asarray(tunary.pack_bits(torch.from_numpy(r_bits)))
    return q, r


# the small stores of the warp path (C <= 64) at k = 1 and k = C, ties and an exact match
_SMALL_STORES = [(1000, c, k) for c in (1, 2, 10, 31, 32, 33) for k in sorted({1, c})]


@pytest.mark.parametrize(
    "d,n_rows,k",
    [(1000, 64, 1), (1000, 64, 8), (1000, 64, 64), (257, 100, 8), *_SMALL_STORES],
)
def test_hamming_topk_matches_jax_oracle(jax_side, d, n_rows, k):
    q, r = _packed_store(d + k, 6, n_rows, d)
    want_i, want_d = jref.hamming_topk_oracle(
        jnp.asarray(q.view(np.uint32)), jnp.asarray(r.view(np.uint32)), d, k
    )
    for fn in (tops.hamming_topk, tref.hamming_topk_oracle):
        got_i, got_d = fn(torch.from_numpy(q), torch.from_numpy(r), d, k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_hamming_topk_all_equal_distances_pin_lowest_indices():
    """Every row at the same distance: the winners are rows 0..k-1."""
    q = np.zeros((3, 4), np.int32)
    r = np.full((40, 4), 0x0F0F0F0F, np.int32)
    idx, dist = tref.hamming_topk(torch.from_numpy(q), torch.from_numpy(r), 128, 8, block_c=16)
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(8), (3, 1)))
    np.testing.assert_array_equal(dist.numpy(), np.full((3, 8), 64))


def test_hamming_topk_rejects_k_out_of_range():
    q, r = _packed_store(0, 2, 5, 64)
    for k in (0, 6):
        with pytest.raises(ValueError, match="k must be in"):
            tops.hamming_topk(torch.from_numpy(q), torch.from_numpy(r), 64, k)


@pytest.mark.parametrize(
    "n_rows,k,want",
    [(1, 1, "warp"), (10, 1, "warp"), (33, 33, "warp"), (64, 64, "warp"), (65, 1, "tensor"),
     (65, 32, "tensor"), (65, 33, "tensor"), (65548, 8, "tensor"), (65548, 33, "tensor"),
     (1000, 1000, "tensor")],
)
def test_topk_path_chooses_from_shape(n_rows, k, want):
    # a store of at most 64 rows fits two keys a lane of one warp, a larger one takes the
    # tensor-core scan; both paths take any k in [1, C], so k does not enter the choice
    assert 1 <= k <= n_rows
    assert tops.topk_path(n_rows) == want


@pytest.mark.parametrize(
    "dtype,h,c,want",
    [(torch.uint8, 784, 10, "histogram"), (torch.uint8, 113, 48, "histogram"),
     (torch.uint8, 784, 49, "direct"), (torch.uint8, 784, 0, "direct"),
     (torch.uint16, 784, 10, "direct"), (torch.uint32, 49, 2, "direct"),
     (torch.uint8, 2**16, 4, "histogram"), (torch.uint8, 2**16 + 1, 4, "direct")],
)
def test_fit_dynamic_path_chooses_from_dtype_and_shape(dtype, h, c, want):
    # uint8 entries put every threshold below 256; a histogram block holds (4, 257, C
    # rounded up to 4) counts, and G = (H, 256, C rounded up to 4) int32 stays within 256 MiB
    assert tops.fit_dynamic_path(dtype, h, c) == want


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,d,skip,levels",
    [(64, 784, 8192, 1, 16), (64, 784, 2048, 1 + 2048, 16), (64, 784, 2040, 1 + 2040, 16),
     (65, 784, 8192, 1, 16), (2048, 784, 8192, 1, 16), (64, 784, 2048, 2**32 - 5, 16),
     (37, 100, 1000, 1000, 16), (5, 49, 300, 2**32 - 3, 2), (33, 113, 257, 0, 256),
     (9, 40, 200, 3, 2**16), (3, 5, 33, 7, 16)],
)
def test_cuda_encode_bundle_dynamic_equals_plain(cuda, b, h, d, skip, levels):
    # the D-shard widths, two row tiles (B = 65), B = 2048 (no H split), skips near
    # 2**32, thresholds of 8 and 16 bits (the int32 compares), and H below one split
    x, _, dirs = _inputs(b + h, b, h, levels=levels)
    xt, dt = torch.from_numpy(x).to(cuda), torch.from_numpy(dirs).to(cuda)
    got = tops.encode_bundle_dynamic(xt, dt, d, skip=skip)
    torch.cuda.synchronize()
    want = tref.encode_bundle_dynamic(xt, dt, d, skip=skip)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,d,c,skip",
    [(512, 784, 8192, 10, 1), (37, 100, 1000, 10, 1000), (300, 49, 300, 200, 7)],
)
def test_cuda_fit_bundle_dynamic_equals_plain(cuda, b, h, d, c, skip):
    x, labels, dirs = _inputs(b + d, b, h, n_classes=c)
    labels[::7] = -1  # out-of-range labels: never written, never summed
    labels[3::11] = c
    xt, dt, lt = (torch.from_numpy(a).to(cuda) for a in (x, dirs, labels))
    got = tops.fit_bundle_dynamic(xt, dt, lt, c, d, skip=skip)
    torch.cuda.synchronize()
    want = tref.fit_bundle_dynamic(xt, dt, lt, c, d, skip=skip)
    assert torch.equal(got, want)


# the tensor path's edges: a partial query tile (B < 64, B % 64 != 0), rows shorter than
# a staged chunk of 256 words (D = 1000) and rows over two chunks (D = 10000), two tiles
# (C = 300) and merge passes (C = 5000), k held as a running list (k <= 32)
_TENSOR_CASES = [(b, c, d, k) for b in (1, 17, 65) for d in (1000, 8192, 10000)
                 for c in (300, 5000) for k in (1, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_q,n_rows,d,k",
    [(64, 10, 8192, 1), (64, 5000, 8192, 8), (6, 1000, 1000, 1000), (3, 777, 257, 64),
     (9, 600, 64, 300), *_TENSOR_CASES],
)
def test_cuda_hamming_topk_equals_plain(cuda, n_q, n_rows, d, k):
    q, r = _packed_store(n_rows + k, n_q, n_rows, d)
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    got_i, got_d = tops.hamming_topk(qt, rt, d, k)
    torch.cuda.synchronize()
    want_i, want_d = tref.hamming_topk(qt, rt, d, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 64, 65])
@pytest.mark.parametrize("n_rows,k", [(c, k) for _, c, k in _SMALL_STORES])
def test_cuda_hamming_topk_warp_path_equals_plain(cuda, n_q, n_rows, k):
    # one warp a query, the class store's shapes: no sort and no merge launch
    q, r = _packed_store(n_rows * 3 + k, n_q, n_rows, 8192)
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    tops.reset_launches()
    got_i, got_d = tops.hamming_topk(qt, rt, 8192, k)
    torch.cuda.synchronize()
    assert list(tops.LAUNCH_SHAPES["hamming_topk"]) == [
        f"B={n_q} C={n_rows} W=256 k={k} path=warp"]
    want_i, want_d = tref.hamming_topk_oracle(qt, rt, 8192, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 32, 33])
def test_cuda_hamming_topk_store_equals_plain(cuda, k):
    # the 64 MiB ItemMemory store on the tensor path, k up to and past a warp's 32 lanes
    rng = np.random.default_rng(k)
    c, w = 65548, 256
    q = rng.integers(0, 2**32, (64, w), dtype=np.uint32).view(np.int32)
    r = rng.integers(0, 2**32, (c, w), dtype=np.uint32).view(np.int32)
    r[c // 2] = r[1]  # duplicate rows: equal distances, lowest index wins
    r[c - 1] = r[0]
    r[40_000] = q[0]  # an exact match for query 0
    qt, rt = torch.from_numpy(q).to(cuda), torch.from_numpy(r).to(cuda)
    got_i, got_d = tops.hamming_topk(qt, rt, 32 * w, k)
    torch.cuda.synchronize()
    want_i, want_d = tref.hamming_topk(qt, rt, 32 * w, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    assert got_i[0, 0] == 40_000 and got_d[0, 0] == 0


@pytest.mark.cuda
def test_cuda_hamming_topk_search_1m_equals_plain(cuda):
    # the search cell's shape: 64 queries, top 8 of 2^20 rows of 8,192 bits (1 GiB), the
    # rows split over the card's SMs a block each, then merged
    rng = np.random.default_rng(2**20)
    b, c, w, k = 64, 2**20, 256, 8
    q = rng.integers(0, 2**32, (b, w), dtype=np.uint32).view(np.int32)
    rt = torch.randint(-2**31, 2**31 - 1, (c, w), dtype=torch.int32, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(1))
    qt = torch.from_numpy(q).to(cuda)
    near = qt[1].clone()
    near[0] ^= 0b111  # three bits off query 1: a run of equal distances
    rt[254:258] = near  # across the edge of tiles 0 and 1
    rt[8190:8194] = near  # across the edge of 8,192-row blocks (32 tiles a block on 132 SMs)
    rt[900_000] = near  # a ninth at the same distance: the lowest indices win
    dup = qt[2].clone()
    dup[3] ^= 0b11111  # five bits off query 2, as duplicate rows in three tiles
    rt[5] = rt[c // 2 + 7] = rt[c - 1] = dup
    rt[700_001] = qt[0]  # an exact match for query 0
    tops.reset_launches()
    got_i, got_d = tops.hamming_topk(qt, rt, 32 * w, k)
    torch.cuda.synchronize()
    assert list(tops.LAUNCH_SHAPES["hamming_topk"]) == [f"B={b} C={c} W={w} k={k} path=tensor"]
    want_i, want_d = tref.hamming_topk(qt, rt, 32 * w, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    assert got_i[0, 0] == 700_001 and got_d[0, 0] == 0
    assert got_i[1].tolist() == [254, 255, 256, 257, 8190, 8191, 8192, 8193]
    assert got_d[1].tolist() == [3] * 8
    assert got_i[2, :3].tolist() == [5, c // 2 + 7, c - 1] and got_d[2, :3].tolist() == [5] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 63, 65])
@pytest.mark.parametrize("n_rows", [65, 255, 257])
@pytest.mark.parametrize("k", [1, 8, 65])
def test_cuda_hamming_topk_tensor_ragged_equals_oracle(cuda, n_q, n_rows, k):
    # ragged B and C on the tensor path, k held as a list and k written a tile, and rows
    # one word off their storage's 16-byte boundary (the word-by-word loads)
    q, r = _packed_store(n_q + n_rows + k, n_q, n_rows + 1, 1000)
    qt = torch.from_numpy(q).to(cuda)
    flat = torch.from_numpy(r).to(cuda).reshape(-1)
    w = r.shape[1]
    for rt in (flat[:n_rows * w].view(n_rows, w), flat[1:1 + n_rows * w].view(n_rows, w)):
        assert tops.topk_path(n_rows) == "tensor"
        got_i, got_d = tops.hamming_topk(qt, rt, 1000, min(k, n_rows))
        torch.cuda.synchronize()
        want_i, want_d = tref.hamming_topk_oracle(qt, rt, 1000, min(k, n_rows))
        assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_q,n_rows,d,k",
    [(65, 65548, 10000, 8), (65, 65548, 10000, 33), (65, 65548, 10240, 8),
     (65, 65548, 10240, 33), (64, 10000, 8192, 8), (64, 10000, 10000, 32)],
)
def test_cuda_hamming_topk_tensor_tilings_equal_plain(cuda, n_q, n_rows, d, k):
    # 65,548 rows are 257 tiles, two or more a block on a card of 129 to 256 SMs: rows over
    # two staged chunks (D = 10,000 word by word, D = 10,240 in 16-byte loads) restage the
    # queries at each later tile, for the list kept over tiles (k <= 32) and for a run a
    # tile (k = 33); 10,000 rows on 40 blocks take 32 queries a block on 132 SMs
    gen = torch.Generator(device=cuda).manual_seed(n_rows + d + k)
    w = -(-d // 32)
    bits_q = torch.rand((n_q, d), generator=gen, device=cuda) < 0.5
    bits_r = torch.rand((n_rows, d), generator=gen, device=cuda) < 0.5
    bits_r[n_rows - 2] = bits_r[n_rows - 1] = bits_r[3]  # duplicates in the first and last tiles
    near = bits_q[0].clone()
    near[7] = ~near[7]
    bits_r[254:258] = bits_r[510:514] = near  # eight ties at distance 1 over two tile edges
    qt, rt = tunary.pack_bits(bits_q), tunary.pack_bits(bits_r)
    tops.reset_launches()
    got_i, got_d = tops.hamming_topk(qt, rt, d, k)
    torch.cuda.synchronize()
    assert list(tops.LAUNCH_SHAPES["hamming_topk"]) == [
        f"B={n_q} C={n_rows} W={w} k={k} path=tensor"]
    want_i, want_d = tref.hamming_topk(qt, rt, d, k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    assert got_i[0, :8].tolist() == [254, 255, 256, 257, 510, 511, 512, 513]
    assert got_d[0, :8].tolist() == [1] * 8


@pytest.mark.cuda
def test_cuda_launch_counters_count_kernel_launches(cuda):
    x, labels, dirs = _inputs(0, 8, 49)
    xt, dt, lt = (torch.from_numpy(a).to(cuda) for a in (x, dirs, labels))
    tops.reset_launches()
    tops.encode_bundle_dynamic(xt, dt, 64)
    tops.fit_bundle_dynamic(xt, dt, lt, 10, 64)
    w = tunary.pack_hypervector(tops.encode_bundle_dynamic(xt, dt, 64))
    tops.hamming_topk(w, w, 64, 3)
    tops.hamming_packed(w, w, 64)
    table = torch.from_numpy(tsobol.sobol_table_for_features(49, 64, 16).astype(np.int8)).to(cuda)
    tops.encode_bundle(xt, table)
    tops.fit_bundle(xt, table, lt, 10)
    hv = tops.encode_unary_mxu(xt, table, 16)
    tops.bundle_binarize(hv, lt, 10)
    assert tops.LAUNCHES == {
        "encode_bundle": 1, "fit_bundle": 1,
        "encode_bundle_dynamic": 2, "fit_bundle_dynamic": 1, "hamming_topk": 1,
        "hamming_packed": 1, "encode_unary_mxu": 1, "bundle_binarize": 1,
    }
    # plain versions on the CPU launch nothing
    tops.encode_bundle_dynamic(torch.from_numpy(x), torch.from_numpy(dirs), 64)
    assert tops.LAUNCHES["encode_bundle_dynamic"] == 2


# (B, H, D, C, skip, levels): ragged B, H and D; 8-bit thresholds; C = 26; skips near
# 2**32; a D-shard of 2048 columns starting at point 1 + 2048
_FIT_PATH_CASES = [
    (37, 100, 1000, 10, 1000, 16), (33, 113, 257, 26, 2**32 - 3, 256),
    (256, 784, 2048, 10, 1 + 2048, 16), (65, 30, 130, 10, 2**32 - 100, 16),
    (1, 5, 33, 3, 0, 2), (300, 49, 300, 48, 7, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["histogram", "direct"])
@pytest.mark.parametrize("b,h,d,c,skip,levels", _FIT_PATH_CASES)
def test_cuda_fit_bundle_dynamic_both_paths_equal_plain(cuda, path, b, h, d, c, skip, levels):
    x, labels, dirs = _inputs(b + h + d, b, h, levels=levels, n_classes=c)
    labels[::7] = -1  # out-of-range labels: never written, never summed
    labels[3::11] = c
    rng = np.random.default_rng(b)
    x[1::3, ::4] = rng.integers(-2**31, 2**31, x[1::3, ::4].shape)  # x outside [0, T)
    if path == "direct":  # the same entries, wider: the compare-and-count kernel
        dirs = dirs.astype(np.uint16)
    xt, dt, lt = (torch.from_numpy(a).to(cuda) for a in (x, dirs, labels))
    assert tops.fit_dynamic_path(dt.dtype, h, c) == path
    tops.reset_launches()
    got = tops.fit_bundle_dynamic(xt, dt, lt, c, d, skip=skip)
    torch.cuda.synchronize()
    assert list(tops.LAUNCH_SHAPES["fit_bundle_dynamic"]) == [
        f"B={b} H={h} C={c} D={d} dir={dirs.dtype} path={path}"]
    assert torch.equal(got, tref.fit_bundle_dynamic(xt, dt, lt, c, d, skip=skip))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [700, 8160, 8192])
@pytest.mark.parametrize("b", [1, 5, 64, 65, 2048])
def test_cuda_encode_unary_mxu_tiles_equal_plain(cuda, b, d):
    k = 13344  # 104.25 slices of 128 bytes: the last one partly out of bounds
    rng = np.random.default_rng(b + d)
    u = torch.from_numpy((rng.random((b, k)) < 0.06).astype(np.int8)).to(cuda)
    o = torch.from_numpy((rng.random((d, k)) < 0.5).astype(np.int8)).to(cuda)
    got = tops.encode_unary_mxu_operands(u, o, 784)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.encode_unary_mxu(u, o, 784))


@pytest.mark.cuda
def test_cuda_encode_unary_mxu_takes_an_unaligned_view(cuda):
    # a contiguous view one byte into its storage: a TMA tensor map needs a
    # 16-byte aligned base, so the wrapper copies it
    rng = np.random.default_rng(0)
    flat = torch.from_numpy((rng.random(1 + 9 * 640) < 0.3).astype(np.int8)).to(cuda)
    u = flat[1:].view(9, 640)
    assert u.is_contiguous() and u.data_ptr() % 16 != 0
    o = torch.from_numpy((rng.random((70, 640)) < 0.5).astype(np.int8)).to(cuda)
    got = tops.encode_unary_mxu_operands(u, o, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.encode_unary_mxu(u, o, 7))
