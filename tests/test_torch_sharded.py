"""The port's D-sharded paths against the JAX package and its own
single-device paths: the ``hamming_packed`` kernel's plain version,
meshes and sharding rules, ``partial_fit_sharded``,
``ShardedExecution`` predict and search, per-host checkpoint shards
and ``train_hdc --shard-map --ckpt-shards``.

Inputs are made with numpy from a seed and handed to both packages.
Everything is integer arithmetic (and float32 only where the JAX
package computes in float32 exactly), so every comparison is **exact
equality** (no tolerance).  The meshes here name ``"cpu"`` several
times: one process runs the shards one after another, as the JAX tests'
forced host devices do; the JAX side runs on its one CPU device.  The
test marked ``cuda`` holds the kernel against its plain version on a
card (``python -m pytest -m cuda tests/test_torch_sharded.py``) and
skips here.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import HDCConfig, HDCModel, ShardedHDCModel, partial_fit_sharded
from repro_torch.core import unary as tunary
from repro_torch.data import load_dataset
from repro_torch.distributed.sharding import Mesh, ShardingRules, model_axis_for, model_mesh
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train_hdc
from repro_torch.launch.mesh import mesh_for
from repro_torch.serving import (
    DeviceExecution,
    ServingEngine,
    ShardedExecution,
    plan_executions,
)
from repro_torch.serving.execution import _centered_shards

try:  # a machine with a card runs the cuda-marked test alone, and may have no JAX
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import HDCModel as JModel
    from repro.core import hdc_model as jhm
    from repro.core.model import HDCConfig as JConfig
    from repro.distributed import sharding as jsharding
    from repro.kernels import ref as jref
    from repro.kernels.hamming_packed import hamming_packed_pallas
    from repro.launch import mesh as jmesh
except ModuleNotFoundError:
    jax = None

N_FEATURES, N_CLASSES = 24, 4


@pytest.fixture(autouse=True)
def _jax_side(request):
    if jax is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs the JAX package")


def _packed(seed: int, b: int, c: int, d: int):
    """Random packed queries and rows, with a duplicate row and an exact match."""
    rng = np.random.default_rng(seed)
    q_bits = rng.random((b, d)) < 0.5
    r_bits = rng.random((c, d)) < 0.5
    if c > 2:
        r_bits[c - 1] = r_bits[0]
        r_bits[1] = q_bits[0]
    pack = lambda bits: tunary.pack_bits(torch.from_numpy(bits))  # noqa: E731
    return pack(q_bits), pack(r_bits)


# ---------------------------------------------------------------------------
# kernel 6: hamming_packed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b,c,d",
    [(1, 1, 1), (5, 3, 31), (13, 10, 100), (37, 9, 1000), (64, 10, 2040), (3, 130, 257),
     (9, 64, 2040), (9, 65, 257)],  # both sides of the warp path's limit
)
def test_hamming_packed_equals_jax(b, c, d):
    q, rows = _packed(b * 31 + c + d, b, c, d)
    qj, rj = (jnp.asarray(t.numpy().view(np.uint32)) for t in (q, rows))
    want = np.asarray(jref.hamming_packed(qj, rj, d))
    np.testing.assert_array_equal(
        np.asarray(hamming_packed_pallas(qj, rj, d, interpret=True)), want
    )
    got = tops.hamming_packed(q, rows, d)  # a CPU tensor: the plain version
    assert got.dtype == torch.int32 and got.shape == (b, c)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.hamming_packed(q, rows, d, block_c=4).numpy(), want)


@pytest.mark.parametrize(
    "n_rows,want",
    [(1, "warp"), (10, "warp"), (63, "warp"), (64, "warp"), (65, "tensor"), (130, "tensor"),
     (65548, "tensor"), (1048561, "tensor")],
)
def test_packed_path_chooses_from_shape(n_rows, want):
    # a store of at most 64 rows gives each lane of a query's warp two scores; a larger
    # one takes the binary products on the tensor cores; B and W do not enter the choice
    assert tops.packed_path(n_rows) == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# (B, C, d, unaligned): the warp path (C <= 64) and the tensor path (C > 64) at one query,
# a partial and a whole m16 / 64-query tile and one past it, d ragged (33, 2040) and whole;
# the 64 MiB store; and rows that are a view off a 16-byte boundary (element loads)
_PACKED_CASES = [
    (64, 10, 8192, False), (64, 10, 2040, False), (37, 5000, 1000, False), (3, 7, 33, False),
    *[(b, c, d, False) for b in (1, 63, 64, 65) for c in (1, 64, 65, 300, 5000)
      for d in (33, 2040, 8192)],
    *[(64, 65548, d, False) for d in (33, 2040, 8192)],
    (5, 10, 8192, True), (65, 300, 8192, True), (17, 130, 2040, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,d,unaligned", _PACKED_CASES)
def test_cuda_hamming_packed_equals_plain(cuda, b, c, d, unaligned):
    if c > 5000:  # the store: random words (a float per bit would take gigabytes)
        rng = np.random.default_rng(d)
        w = tunary.n_words(d)
        q, rows = (torch.from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32).view(np.int32))
                   for n in (b, c))
        rows[c - 1] = rows[0]
        rows[40_000] = q[0]
    else:
        q, rows = _packed(b + c + d, b, c, d)
    q, rows = q.to(cuda), rows.to(cuda)
    if unaligned:  # the same rows, 4 bytes past an aligned base
        flat = torch.empty(rows.numel() + 1, dtype=torch.int32, device=cuda)
        flat[1:] = rows.reshape(-1)
        rows = flat[1:].view(rows.shape)
        assert rows.data_ptr() % 16 != 0
    tops.reset_launches()
    got = tops.hamming_packed(q, rows, d)
    torch.cuda.synchronize()
    path = "warp" if c <= 64 else "tensor"
    assert tops.LAUNCHES["hamming_packed"] == 1
    assert list(tops.LAUNCH_SHAPES["hamming_packed"]) == [
        f"B={b} C={c} W={rows.shape[1]} path={path}"]
    assert torch.equal(got, tref.hamming_packed(q, rows, d))


# ---------------------------------------------------------------------------
# meshes and rules
# ---------------------------------------------------------------------------


def _grid(shape, axes):
    cells = np.empty(int(np.prod(shape)), dtype=object)
    cells[:] = ["cpu"] * cells.size
    return Mesh(cells.reshape(shape), axes)


@pytest.mark.parametrize(
    "shape,axes", [((1,), ("model",)), ((4,), ("model",)), ((2, 4), ("data", "model")),
                   ((2, 2, 2), ("pod", "data", "model")), ((3,), ("data",))],
)
def test_model_axis_for_and_batch_axes_equal_jax(shape, axes):
    """The JAX package's rules read only a mesh's axis names and shape, so
    they take the port's mesh as it is."""
    mesh = _grid(shape, axes)
    for dim in (1, 2, 3, 4, 8, 12, 1000):
        assert model_axis_for(mesh, dim) == jsharding.model_axis_for(mesh, dim)
    assert ShardingRules().batch_axes(mesh) == jsharding.ShardingRules().batch_axes(mesh)
    groups = ShardingRules().batch_groups(mesh)
    batch = [n for a, n in mesh.shape.items() if a in ("pod", "data")]
    assert len(groups) == int(np.prod(batch)) and len({tuple(g.items()) for g in groups}) == len(groups)


@pytest.mark.parametrize("n,model_parallel", [(1, 16), (2, 16), (6, 16), (8, 16), (8, 4), (12, 16)])
def test_mesh_for_grid_equals_jax(monkeypatch, n, model_parallel):
    monkeypatch.setattr(jmesh, "_make_mesh", lambda shape, axes: (shape, axes))
    shape, axes = jmesh.mesh_for(n, model_parallel)
    mesh = mesh_for(n, model_parallel, devices=["cpu"] * n)
    assert mesh.axis_names == axes and tuple(mesh.shape.values()) == shape


def test_mesh_validates_and_compares():
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu", "cpu"], ("data", "model"))
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([], ("model",))
    with pytest.raises(ValueError, match="empty device list"):
        model_mesh([])
    with pytest.raises(ValueError, match="2 given"):
        mesh_for(4, devices=["cpu", "cpu"])
    assert model_mesh(["cpu"] * 3) == model_mesh(["cpu"] * 3) != model_mesh(["cpu"] * 2)
    assert model_mesh(["cpu"] * 3).platform == "cpu"


def test_meshes_default_to_the_cards_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (model_mesh, mesh_for, lambda: plan_executions(128),
                 lambda: Mesh(["cuda"], ("model",))):
        with pytest.raises(RuntimeError, match="cpu"):
            make()


# ---------------------------------------------------------------------------
# plan_executions (mirrors tests/test_sharded_serving.py:89-118)
# ---------------------------------------------------------------------------


def test_plan_executions_validates_placement_and_replicas():
    with pytest.raises(ValueError, match="valid: auto, device, sharded"):
        plan_executions(128, placement="mesh", devices=["cpu"])
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        plan_executions(128, replicas=0, devices=["cpu"])


def test_plan_executions_default_is_one_single_device_engine():
    (ex,) = plan_executions(128, devices=["cpu", "cpu"])
    assert isinstance(ex, DeviceExecution) and ex.device == torch.device("cpu")


def test_plan_executions_device_placement_round_robins():
    execs = plan_executions(128, replicas=3, placement="device", devices=["cpu"])
    assert len(execs) == 3 and all(isinstance(ex, DeviceExecution) for ex in execs)


def test_plan_executions_groups_shard_where_d_divides():
    execs = plan_executions(120, replicas=2, devices=["cpu"] * 5)
    assert [type(ex) for ex in execs] == [ShardedExecution, ShardedExecution]
    assert [ex.n_shards for ex in execs] == [3, 2]
    execs = plan_executions(129, replicas=2, devices=["cpu"] * 4)  # 129 % 2: pin
    assert [type(ex) for ex in execs] == [DeviceExecution, DeviceExecution]


def test_plan_executions_sharded_refuses_non_dividing_d():
    with pytest.raises(ValueError, match="does not divide"):
        plan_executions(129, placement="sharded", devices=["cpu", "cpu"])


def test_sharded_execution_rejects_mesh_and_devices():
    with pytest.raises(ValueError, match="mesh or devices, not both"):
        ShardedExecution(mesh=model_mesh(["cpu"]), devices=["cpu"])
    ex = ShardedExecution(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="cannot shard D=128"):
        ex.place(HDCModel.create(HDCConfig(N_FEATURES, N_CLASSES, d=128), device="cpu"))


# ---------------------------------------------------------------------------
# D-sharded training
# ---------------------------------------------------------------------------


def _cfg_kw(encoder: str, d: int, **kw) -> dict:
    return dict(n_features=N_FEATURES, n_classes=N_CLASSES, d=d, levels=16, encoder=encoder,
                sobol_skip=3, **kw)


def _batches(seed: int = 0, n: int = 32, steps: int = 2):
    rng = np.random.default_rng(seed)
    return [
        (rng.uniform(0, 255, (n, N_FEATURES)).astype(np.float32),
         rng.integers(0, N_CLASSES, n).astype(np.int32))
        for _ in range(steps)
    ]


@functools.lru_cache(maxsize=None)
def _jax_class_sums(encoder: str, d: int) -> np.ndarray:
    model = JModel.create(JConfig(**_cfg_kw(encoder, d)))
    for x, y in _batches():
        model = jhm.partial_fit(model, jnp.asarray(x), jnp.asarray(y))
    return np.asarray(model.class_sums)


MESHES = {"1x1": (1, 1), "2x4": (2, 4), "1x8": (1, 8)}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("d", [128, 200])  # 200 over 8 (or 4) shards: d_local % 32 != 0
@pytest.mark.parametrize("encoder", ["uhd", "uhd_dynamic"])
def test_partial_fit_sharded_equals_partial_fit_and_jax(encoder, d, mesh_name):
    data, model_axis = MESHES[mesh_name]
    mesh = mesh_for(data * model_axis, model_axis, devices=["cpu"] * 8)
    assert mesh.shape == {"data": data, "model": model_axis}
    cfg = HDCConfig(**_cfg_kw(encoder, d))
    plain = sharded = HDCModel.create(cfg, device="cpu")
    for x, y in _batches():
        plain = plain.partial_fit(x, y)
        sharded = partial_fit_sharded(sharded, x, y, mesh=mesh)
    assert isinstance(sharded, ShardedHDCModel) and sharded.n_shards == model_axis
    assert [sh.class_sums.shape for sh in sharded.shards] == [(N_CLASSES, d // model_axis)] * model_axis
    assert sharded.n_examples == plain.n_examples == 64
    assert torch.equal(sharded.class_sums, plain.class_sums)
    np.testing.assert_array_equal(sharded.class_sums.numpy(), _jax_class_sums(encoder, d))
    for k, v in plain.codebooks.items():
        assert torch.equal(sharded.codebooks[k], v), k


def test_sharded_table_slices_are_contiguous_and_placed_per_cell():
    cfg = HDCConfig(**_cfg_kw("uhd", 128))
    sharded = HDCModel.create(cfg, device="cpu").shard(mesh_for(8, 4, devices=["cpu"] * 8))
    table = HDCModel.create(cfg, device="cpu").codebooks["sobol"]
    for sh in sharded.shards:
        got = sharded.books(sh.index, sh.device)["sobol"]
        assert got.is_contiguous() and torch.equal(got, table[:, sh.offset : sh.offset + 32])
    plan = HDCModel.create(cfg, device="cpu").shardings(mesh_for(8, 4, devices=["cpu"] * 8))
    assert plan == {"class_sums": "model", "codebooks/sobol": "model", "n_seen": None}


def test_partial_fit_sharded_validates_batch_and_labels():
    cfg = HDCConfig(**_cfg_kw("uhd_dynamic", 128))
    mesh = mesh_for(6, 2, devices=["cpu"] * 6)  # 3 batch shards
    model = HDCModel.create(cfg, device="cpu")
    (x, y), _ = _batches(n=32)
    with pytest.raises(ValueError, match="must divide the 3-way batch"):
        partial_fit_sharded(model, x, y, mesh=mesh)
    bad = y[:30].copy()
    bad[0] = N_CLASSES
    with pytest.raises(ValueError, match="labels must be in"):
        partial_fit_sharded(model, x[:30], bad, mesh=mesh)


# ---------------------------------------------------------------------------
# D-sharded serving
# ---------------------------------------------------------------------------


def _models(encoder: str, d: int):
    """A port model and its JAX twin with crafted class sums: classes 0
    and 2 are equal, so every query ties between them (lowest index wins)."""
    rng = np.random.default_rng(d)
    sums = rng.integers(-400, 400, (N_CLASSES, d)).astype(np.int32)
    sums[2] = sums[0]
    cfg = HDCConfig(**_cfg_kw(encoder, d, similarity="hamming"))
    model = HDCModel(cfg, HDCModel.create(cfg, device="cpu").codebooks, torch.from_numpy(sums),
                     64, device="cpu")
    jcfg = JConfig(**_cfg_kw(encoder, d, similarity="hamming"))
    jmodel = JModel.from_parts(jcfg, JModel.create(jcfg).codebooks, jnp.asarray(sums), 64)
    return model, jmodel


@functools.lru_cache(maxsize=None)
def _jax_served(encoder: str, d: int, k: int):
    _, jmodel = _models(encoder, d)
    images = jnp.asarray(_queries())
    words = jmodel.pack()
    idx, dist = jhm.search_packed(jmodel, images, words, k=k)
    labels = jhm.predict_packed(jmodel, images, words)
    return np.asarray(labels), np.asarray(idx), np.asarray(dist)


def _queries() -> np.ndarray:
    return np.random.default_rng(5).uniform(0, 255, (12, N_FEATURES)).astype(np.float32)


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("d", [128, 200])
@pytest.mark.parametrize("encoder", ["uhd", "uhd_dynamic"])
def test_sharded_predict_and_search_equal_device_and_jax(encoder, d, n_shards):
    model, _ = _models(encoder, d)
    images = _queries()
    want_labels, want_idx, want_dist = _jax_served(encoder, d, 3)
    single = ServingEngine(model, execution=DeviceExecution(device="cpu"))
    sharded = ServingEngine(model, execution=ShardedExecution(devices=["cpu"] * n_shards))
    assert [w.shape for w in sharded.class_words] == [
        (N_CLASSES, tunary.n_words(d // n_shards))
    ] * n_shards
    labels = sharded.predict(images)
    np.testing.assert_array_equal(labels, single.predict(images))
    np.testing.assert_array_equal(labels, want_labels)
    assert 2 not in labels  # class 2 ties with class 0 everywhere: 0 wins
    idx, dist = sharded.search(images, 3)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(dist, want_dist)
    single_idx, single_dist = single.search(images, 3)
    np.testing.assert_array_equal(idx, single_idx)
    np.testing.assert_array_equal(dist, single_dist)
    desc = sharded.describe()
    assert desc["placement"] == "sharded" and desc["execution"]["n_shards"] == n_shards
    assert desc["packed_bytes"] == 4 * N_CLASSES * n_shards * tunary.n_words(d // n_shards)
    assert desc["codebook_bytes"] == single.describe()["codebook_bytes"]


def test_sharded_centring_equals_single_device_and_jax_division():
    """Row centring of shards: the int64 row sums summed across shards,
    times float32(1/D), equals the single-device centring and the JAX
    package's jitted ``psum(x.sum(-1)) / cfg.d`` wherever its float32 sum
    is exact, including rows equal to their own mean."""
    cfg = HDCConfig(**_cfg_kw("uhd", 1000))
    rng = np.random.default_rng(0)
    hv = rng.integers(-784, 785, (64, 1000)).astype(np.int32)
    hv[:8] = 7  # rows equal to their own mean: float32 centres them to -4.8e-7
    t = torch.from_numpy(hv)
    whole = jax.jit(functools.partial(jhm._centered, JConfig(**_cfg_kw("uhd", 1000))))(
        jnp.asarray(hv)
    )
    jax_sharded = jax.jit(lambda x: x - x.sum(-1, keepdims=True) / 1000)(
        jnp.asarray(hv, jnp.float32)
    )
    parts = _centered_shards(cfg, list(torch.split(t, 125, dim=1)), torch.device("cpu"))
    got = torch.cat(parts, dim=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sharded))
    np.testing.assert_array_equal(got, np.asarray(whole))


@pytest.mark.parametrize("d", [256, 200])
def test_shard_words_splits_a_store_as_pack_does(d):
    model, _ = _models("uhd", d)
    ex = ShardedExecution(devices=["cpu"] * 4)
    whole = model.pack()  # (C, W) packed over the whole D
    uncentered = dataclasses.replace(model.cfg, pack_center="none")
    flat = HDCModel(uncentered, model.codebooks, model.class_sums, device="cpu")
    parts = ex.shard_words(flat.pack(), d)
    assert [torch.equal(p, w) for p, w in zip(parts, ex.pack(flat))] == [True] * 4
    images = _queries()
    idx, dist = ex.search(model, ex.shard_words(whole, d), images, 2)
    want_i, want_d = DeviceExecution(device="cpu").search(model, whole, images, 2)
    assert torch.equal(idx, want_i) and torch.equal(dist, want_d)


# ---------------------------------------------------------------------------
# per-host checkpoint shards
# ---------------------------------------------------------------------------


def _trained(encoder: str, d: int = 704):
    cfg = HDCConfig(**_cfg_kw(encoder, d))
    model = HDCModel.create(cfg, device="cpu")
    for x, y in _batches():
        model = model.partial_fit(x, y)
    return model


def _manifest(root, step: int = 3) -> dict:
    m = json.loads((root / f"step_{step:09d}" / "manifest.json").read_text())
    return {k: v for k, v in m.items() if k != "time"}


@pytest.mark.parametrize("encoder", ["uhd", "uhd_dynamic"])
def test_port_shards_load_in_both_packages(tmp_path, encoder):
    model = _trained(encoder)
    for pi in range(4):
        model.save_shard(tmp_path / "ckpt", step=3, process_index=pi, process_count=4)
    CheckpointManager(tmp_path / "ckpt").finalize_shards(3)
    back = HDCModel.load(tmp_path / "ckpt", device="cpu")
    assert back.cfg == model.cfg and back.n_examples == 64
    assert torch.equal(back.class_sums, model.class_sums)
    jback = JModel.load(tmp_path / "ckpt")
    assert jback.n_examples == 64
    np.testing.assert_array_equal(np.asarray(jback.class_sums), model.class_sums.numpy())
    for k, v in model.codebooks.items():
        np.testing.assert_array_equal(np.asarray(jback.codebooks[k]), v.numpy())
    # loaded onto a mesh: every D-slice on its shard, the stitched state equal
    on_mesh = HDCModel.load(tmp_path / "ckpt", mesh=model_mesh(["cpu"] * 8))
    assert on_mesh.n_shards == 8 and torch.equal(on_mesh.class_sums, model.class_sums)


@pytest.mark.parametrize("encoder", ["uhd", "uhd_dynamic"])
def test_jax_shards_load_in_the_port_and_manifests_agree(tmp_path, encoder):
    model = _trained(encoder)
    jmodel = JModel.create(JConfig(**_cfg_kw(encoder, 704)))
    jmodel = jmodel.replace(class_sums=jnp.asarray(model.class_sums.numpy()),
                            n_seen=jhm._nseen_array(64))
    for pi in range(4):
        jmodel.save_shard(tmp_path / "jax", step=3, process_index=pi, process_count=4)
        model.save_shard(tmp_path / "port", step=3, process_index=pi, process_count=4)
    JManager(tmp_path / "jax").finalize_shards(3)
    CheckpointManager(tmp_path / "port").finalize_shards(3)
    back = HDCModel.load(tmp_path / "jax", device="cpu")
    assert torch.equal(back.class_sums, model.class_sums) and back.n_examples == 64
    for k, v in model.codebooks.items():
        assert torch.equal(back.codebooks[k], v), k
    assert _manifest(tmp_path / "jax") == _manifest(tmp_path / "port")
    step = "step_000000003"
    for f in sorted((tmp_path / "jax" / step).glob("leaf_*.npy")):
        assert f.read_bytes() == (tmp_path / "port" / step / f.name).read_bytes(), f.name


def test_aborted_shard_attempt_cannot_tear_next_save(tmp_path):
    """Mirrors tests/test_fit_bundle.py:358: host 0's save_shard clears
    the staging of an attempt that died before finalize."""
    run1 = _trained("uhd", 128)
    for pi in range(2):
        run1.save_shard(tmp_path / "ckpt", step=0, process_index=pi, process_count=2)
    x, y = _batches(seed=1, steps=1)[0]
    run2 = run1.partial_fit(x, y)
    run2.save_shard(tmp_path / "ckpt", step=0, process_index=0, process_count=2)
    mgr = CheckpointManager(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError, match="missing shard"):
        mgr.finalize_shards(0)
    run2.save_shard(tmp_path / "ckpt", step=0, process_index=1, process_count=2)
    mgr.finalize_shards(0)
    assert torch.equal(HDCModel.load(tmp_path / "ckpt", device="cpu").class_sums, run2.class_sums)


def test_incomplete_shard_set_refuses_to_publish(tmp_path):
    """Mirrors tests/test_fit_bundle.py:383."""
    model = _trained("uhd", 128)
    model.save_shard(tmp_path / "ckpt", step=0, process_index=0, process_count=2)
    mgr = CheckpointManager(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError, match="missing shard"):
        mgr.finalize_shards(0)
    assert mgr.all_steps() == []
    model.save_shard(tmp_path / "ckpt", step=0, process_index=1, process_count=2)
    mgr.finalize_shards(0)
    assert mgr.all_steps() == [0]
    with pytest.raises(ValueError, match="shards"):
        model.save_shard(tmp_path / "ckpt", step=1, process_index=0, process_count=3)
    with pytest.raises(FileNotFoundError, match="no staged manifest"):
        mgr.finalize_shards(7)


def test_sharded_engine_from_sharded_checkpoint(tmp_path):
    model = _trained("uhd_dynamic", 200)
    sharded = model.shard(mesh_for(8, 4, devices=["cpu"] * 8))
    for pi in range(4):
        sharded.save_shard(tmp_path / "ckpt", step=2, process_index=pi, process_count=4)
    CheckpointManager(tmp_path / "ckpt").finalize_shards(2)
    ex = ShardedExecution(devices=["cpu"] * 4)
    engine = ServingEngine.from_checkpoint(tmp_path / "ckpt", execution=ex)
    assert isinstance(engine.model, ShardedHDCModel) and engine.step == 2
    images = _queries()
    single = ServingEngine(model, device="cpu")
    np.testing.assert_array_equal(engine.predict(images), single.predict(images))
    assert engine.warmup() is engine


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_train_hdc_shard_map_ckpt_shards_equals_jax(tmp_path, capsys):
    argv = ["--device", "cpu", "--d", "256", "--n-train", "512", "--n-test", "64",
            "--batch-size", "256", "--encoder", "uhd_dynamic", "--shard-map",
            "--ckpt-shards", "4", "--save-dir", str(tmp_path / "ckpt")]
    result = train_hdc.train(train_hdc.parser().parse_args(argv))
    out = capsys.readouterr().out
    assert "round-trip ok: True, 4 host shards" in out and "shard_map" in out
    assert result.round_trip_ok is True and isinstance(result.model, ShardedHDCModel)
    ds = load_dataset("synth_mnist", n_train=512, n_test=64)
    jmodel = JModel.create(JConfig(n_features=784, n_classes=10, d=256, encoder="uhd_dynamic"))
    jmodel = jmodel.fit_batches(
        (ds.train_images[i : i + 256], ds.train_labels[i : i + 256]) for i in (0, 256)
    )
    np.testing.assert_array_equal(result.model.class_sums.numpy(), np.asarray(jmodel.class_sums))
    np.testing.assert_array_equal(
        np.asarray(JModel.load(tmp_path / "ckpt").class_sums), np.asarray(jmodel.class_sums)
    )
    assert train_hdc.main(argv) == 0
