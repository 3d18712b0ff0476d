"""The port's optimizer, gradient compression and sharding rules against
the JAX package's, on the CPU.

* ``repro_torch.optim``: ``lr_at`` over the three schedules,
  ``clip_by_global_norm`` and three ``adamw_step``s on a random tree with
  2-D, 1-D and bfloat16 leaves equal JAX's (jitted) to rtol 1e-6.  On an
  x86 CPU with FMA they are bit-exact (the update rounds each ``c * b +
  a`` once, as XLA's fused multiply-add does); the tolerance covers a
  machine where either library rounds twice.
* ``repro_torch.distributed.compress``: int8 values, packed sign words
  and dequantized values bit-exact; the error-feedback quadratic; an
  8-process gloo run (2 pods x 4 data) equal to JAX's 8-host-device
  ``shard_map`` result, bit for bit (dyadic inputs: every sum is exact).
* ``repro_torch.distributed.sharding``: ``param_spec``, ``activation_spec``
  and ``tree_param_shardings`` equal JAX's spec by spec on every arch's
  full config, on (1, 1), (2, 4), (16, 16) and (2, 16, 16) meshes (the
  last two of repeated "cpu" cells), fsdp on and off, parameters and
  decode states; ``make_production_mesh`` and ``abstract_params``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget_config
from repro.core import unary as junary
from repro.distributed import compress as jcompress
from repro.distributed import sharding as jsharding
from repro.models import params as jparams_mod
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config as tget_config
from repro_torch.core import unary as tunary
from repro_torch.distributed import compress as tcompress
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch.mesh import make_production_mesh, mesh_for
from repro_torch.models import params as tparams_mod
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import tree_leaves

SRC = str(Path(__file__).resolve().parents[1] / "src")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_equals_jax(schedule):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=110, schedule=schedule, min_lr_frac=0.1)
    jcfg, tcfg = jadamw.OptimizerConfig(**cfg), tadamw.OptimizerConfig(**cfg)
    jlr = jax.jit(lambda s: jadamw.lr_at(jcfg, s))
    for step in (0, 1, 5, 10, 11, 37, 60, 109, 110, 200):
        want = np.float32(jlr(jnp.int32(step)))
        got = tadamw.lr_at(tcfg, step)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, err_msg=f"step {step}")
    assert tadamw.lr_at(tadamw.OptimizerConfig(warmup_steps=0, schedule="constant"), 3).item() == \
        pytest.approx(3e-4)


def _random_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((16, 8)).astype(np.float32),
        "stack": {"a": rng.standard_normal((2, 4, 6)).astype(np.float32),
                  "norm": rng.standard_normal(6).astype(np.float32)},
        "bias": rng.standard_normal(5).astype(np.float32),
        "half": rng.standard_normal((8, 4)).astype(np.float32),  # the bfloat16 leaf
    }


def _as_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["half"] = out["half"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = {k: _as_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in tree.items()}
    if "half" in out:
        out["half"] = out["half"].to(torch.bfloat16)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_clip_by_global_norm_equals_jax():
    grads = jax.tree.map(lambda a: a * 3.0, _random_tree(1))
    for max_norm in (1.0, 1e6):
        jg, jn = jax.jit(lambda g: jadamw.clip_by_global_norm(g, max_norm))(_as_jax(grads))
        tg, tn = tadamw.clip_by_global_norm(_as_torch(grads), max_norm)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6)
    # JAX's own example: norm 5 clipped to 1
    g, n = tadamw.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert n.item() == pytest.approx(5.0)
    np.testing.assert_allclose(g["a"].numpy(), [0.6, 0.8], rtol=1e-6)


def test_adamw_steps_equal_jax_with_1d_and_bf16_leaves():
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jcfg, tcfg = jadamw.OptimizerConfig(**cfg), tadamw.OptimizerConfig(**cfg)
    jp, tp = _as_jax(_random_tree(0)), _as_torch(_random_tree(0))
    jo, to = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    jstep = jax.jit(lambda p, g, o, s: jadamw.adamw_step(jcfg, p, g, o, s))
    for step in range(3):
        grads = _random_tree(10 + step)
        jp, jo, jlr = jstep(jp, _as_jax(grads), jo, jnp.int32(step))
        ptrs = [t.data_ptr() for t in tree_leaves(tp)]
        tp, to, tlr = tadamw.adamw_step(tcfg, tp, _as_torch(grads), to, step)
        assert [t.data_ptr() for t in tree_leaves(tp)] == ptrs  # updated in place
        assert tlr.item() == float(jlr)
        assert tp["half"].dtype == torch.bfloat16 and tp["stack"]["norm"].dtype == torch.float32
        for name, j, t in (("params", jp, tp), ("m", jo["m"], to["m"]), ("v", jo["v"], to["v"])):
            for a, b in zip(jax.tree.leaves(j), tree_leaves(t)):
                np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, err_msg=f"{name}, step {step}")


def test_weight_decay_is_masked_to_matrices():
    """A zero gradient moves a 2-D leaf by lr * wd * p alone and leaves a
    1-D leaf where it is."""
    cfg = tadamw.OptimizerConfig(lr=0.5, warmup_steps=0, schedule="constant", weight_decay=0.1)
    p = {"w": torch.ones(2, 2), "b": torch.ones(3)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(3)}
    tadamw.adamw_step(cfg, p, g, tadamw.init_opt_state(p), 0)
    np.testing.assert_allclose(p["w"].numpy(), np.float32(1 - 0.5 * 0.1))
    np.testing.assert_array_equal(p["b"].numpy(), 1.0)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_int8_quantization_equals_jax():
    v = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    scale = np.float32(np.abs(v).max())
    jq = np.asarray(jax.jit(jcompress.quantize_int8)(v, scale))
    tq = tcompress.quantize_int8(torch.from_numpy(v), torch.tensor(scale))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), jq)
    jd = np.asarray(jax.jit(jcompress.dequantize_int8)(jq, scale))
    td = tcompress.dequantize_int8(tq, torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(td, jd)
    assert np.abs(v - td).max() <= scale / 127.0


def test_sign_compression_packed_equals_jax():
    v = np.random.default_rng(1).standard_normal((8, 17)).astype(np.float32)
    jw, js = jax.jit(jcompress.sign_compress_packed)(v)
    tw, ts = tcompress.sign_compress_packed(torch.from_numpy(v))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_allclose(ts.item(), float(js), rtol=1e-6)
    back = tcompress.sign_decompress_packed(tw, ts, (8, 17))
    jback = jcompress.sign_decompress_packed(jw, js, (8, 17))
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-6)
    assert np.array_equal(np.sign(back.numpy()), np.sign(v))


def test_error_feedback_converges_on_quadratic():
    """The port of tests/test_distributed.py's quadratic: EF-compressed
    SGD reaches the optimum (one worker: the EF algebra alone)."""
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])
    x, err = torch.zeros(4), torch.zeros(4)
    for _ in range(300):
        v = (x - target) + err
        scale = torch.max(torch.abs(v)) + 1e-12
        ghat = tcompress.dequantize_int8(tcompress.quantize_int8(v, scale), scale)
        err = v - ghat
        x = x - 0.1 * ghat
    assert float(torch.abs(x - target).max()) < 1e-2


def test_error_state_bytes_and_majority_equal_jax():
    tree = _random_tree(2)
    del tree["half"]
    jtree, ttree = jax.tree.map(jnp.asarray, tree), _as_torch(tree)
    assert tcompress.bytes_saved(ttree) == jcompress.bytes_saved(jtree)
    for a, b in zip(jax.tree.leaves(jcompress.init_error_state(jtree)),
                    tree_leaves(tcompress.init_error_state(ttree))):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape and not b.any()
    counts = np.arange(0, 12, dtype=np.int32)
    for h in (7, 8, 11):
        np.testing.assert_array_equal(tunary.majority_threshold(torch.from_numpy(counts), h).numpy(),
                                      np.asarray(junary.majority_threshold(counts, h)))


_SYNC_INPUTS = """
import numpy as np
rng = np.random.default_rng(5)
G = (rng.integers(-64, 64, (8, 16)) / 8.0).astype(np.float32)
E = (rng.integers(-16, 16, (8, 16)) / 64.0).astype(np.float32)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_grad_sync_8_gloo_processes_equal_jax_shard_map():
    """2 pods x 4 data: rank r holds row r of G and E, as JAX's (2, 4)
    ("pod", "data") mesh gives device r row r under P(("pod", "data"))."""
    jax_code = _SYNC_INPUTS + textwrap.dedent("""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        from repro.distributed import compress
        from repro.launch.mesh import _make_mesh
        mesh = _make_mesh((2, 4), ("pod", "data"))
        spec = P(("pod", "data"))
        out, err = jax.jit(shard_map(
            lambda g, e: compress.compressed_grad_sync(g, e), mesh=mesh,
            in_specs=(spec, spec), out_specs=(spec, spec),
        ))({"w": jnp.asarray(G)}, {"w": jnp.asarray(E)})
        print(json.dumps({"out": np.asarray(out["w"]).tolist(), "err": np.asarray(err["w"]).tolist()}))
    """)
    rank_code = _SYNC_INPUTS + textwrap.dedent("""
        import json, sys
        import torch, torch.distributed as dist
        rank, port = int(sys.argv[1]), sys.argv[2]
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=8, rank=rank)
        from repro_torch.distributed import compress
        pod, data = compress.pod_data_groups(2, 4)
        g = {"w": torch.from_numpy(G[rank:rank + 1])}
        e = {"w": torch.from_numpy(E[rank:rank + 1])}
        out, err = compress.compressed_grad_sync(g, e, pod_group=pod, data_group=data)
        assert torch.equal(g["w"], torch.from_numpy(G[rank:rank + 1]))  # inputs untouched
        print(json.dumps({"out": out["w"].tolist(), "err": err["w"].tolist()}))
        dist.destroy_process_group()
    """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    port = _free_port()
    ranks = [subprocess.Popen([sys.executable, "-c", rank_code, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(8)]
    jr = subprocess.run([sys.executable, "-c", jax_code], env=env, capture_output=True, text=True,
                        timeout=180)
    outs = []
    for p in ranks:
        stdout, stderr = p.communicate(timeout=180)
        assert p.returncode == 0, stderr[-2000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    assert jr.returncode == 0, jr.stderr[-2000:]
    want = json.loads(jr.stdout.strip().splitlines()[-1])
    got_out = np.concatenate([np.asarray(o["out"], np.float32) for o in outs])
    got_err = np.concatenate([np.asarray(o["err"], np.float32) for o in outs])
    np.testing.assert_array_equal(got_out, np.asarray(want["out"], np.float32))
    np.testing.assert_array_equal(got_err, np.asarray(want["err"], np.float32))


# ---------------------------------------------------------------------------
# sharding rules and meshes
# ---------------------------------------------------------------------------


class _AxesMesh:
    """What JAX's ``param_spec`` reads of a mesh: its shape and axis names."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _meshes():
    grid = lambda shape: np.array(["cpu"] * int(np.prod(shape)), dtype=object).reshape(shape)  # noqa: E731
    return {
        "1x1": mesh_for(devices=["cpu"]),
        "2x4": tsharding.Mesh(grid((2, 4)), ("data", "model")),
        "16x16": make_production_mesh(devices=["cpu"] * 256),
        "2x16x16": make_production_mesh(multi_pod=True, devices=["cpu"] * 512),
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", ["1x1", "2x4", "16x16", "2x16x16"])
def test_param_and_state_specs_equal_jax_on_every_full_config(mesh_name, fsdp):
    mesh = _meshes()[mesh_name]
    jmesh = _AxesMesh(mesh.shape)
    jr, tr = jsharding.ShardingRules(fsdp=fsdp), tsharding.ShardingRules(fsdp=fsdp)
    n = 0
    for arch in ARCHS:
        jc, tc = jget_config(arch), tget_config(arch)
        specs = tparams_mod.param_specs(tc)
        shardings = tsharding.tree_param_shardings(mesh, specs, tparams_mod.spec_tree_axes(tc), tr)
        jspecs = dict(_flat(jparams_mod.param_specs(jc)))
        for (key, spec), (_, sh) in zip(_flat(specs), _flat(shardings)):
            assert jspecs[key].shape == spec.shape and jspecs[key].axes == spec.axes, key
            want = tuple(jr.param_spec(spec.shape, spec.axes, jmesh))
            assert tuple(tr.param_spec(spec.shape, spec.axes, mesh)) == want, (arch, key)
            assert tuple(sh.spec) == want and sh.device == torch.device("cpu")
            n += 1
        # decode states: the "batch" logical axis
        state = tt.init_decode_state(tc, 128, 1024, device="meta")
        axes = dict(_flat(jt.decode_state_axes(jc), ""))
        for key, leaf in _flat(state):
            if key == "pos":
                continue
            want = tuple(jr.param_spec(tuple(leaf.shape), axes[key], jmesh))
            assert tuple(tr.param_spec(tuple(leaf.shape), axes[key], mesh)) == want, (arch, key)
    assert n > 200


@pytest.mark.parametrize("mesh_name", ["1x1", "2x4", "2x16x16"])
def test_activation_and_data_specs_equal_jax(mesh_name):
    mesh = _meshes()[mesh_name]
    jr, tr = jsharding.ShardingRules(), tsharding.ShardingRules()
    for ndim in (1, 2, 3):
        for bd in range(ndim):
            want = tuple(jr.activation_spec(ndim, _AxesMesh(mesh.shape), batch_dim=bd))
            assert tuple(tr.activation_spec(ndim, mesh, batch_dim=bd)) == want
    sh = tr.data_sharding(mesh)
    assert tuple(sh.spec) == tuple(jr.activation_spec(2, _AxesMesh(mesh.shape)))
    t = sh.place(torch.ones(3))
    assert t.device == torch.device("cpu")


def test_production_mesh_shapes_and_too_few_devices():
    single = make_production_mesh(devices=["cpu"] * 256)
    assert single.shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True, devices=["cpu"] * 600)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    with pytest.raises(ValueError, match="256 devices"):
        make_production_mesh(devices=["cpu"] * 255)
    with pytest.raises(ValueError, match="512 devices"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 511)


def test_sharding_over_distinct_devices_raises():
    mesh = tsharding.Mesh(np.array(["cpu", "cpu:0"], dtype=object).reshape(1, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="torch.distributed.run"):
        tsharding.ShardingRules().param_sharding((4, 4), ("embed", "mlp"), mesh)
    assert tuple(tsharding.ShardingRules().param_spec((4, 4), ("embed", "mlp"), mesh)) == (None, "model")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "llama-3.2-vision-90b"])
def test_abstract_params_have_jax_shapes_on_meta(arch):
    jc, tc = jget_config(arch), tget_config(arch)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    want = jsharding.abstract_params(jc, jmesh, jsharding.ShardingRules(fsdp=True))
    got = tsharding.abstract_params(tc, mesh_for(devices=["cpu"]), tsharding.ShardingRules(fsdp=True))
    wflat, gflat = _flat(want), _flat(got)
    assert [k for k, _ in wflat] == [k for k, _ in gflat]
    for (_, w), (_, g) in zip(wflat, gflat):
        assert g.device.type == "meta" and tuple(g.shape) == w.shape and g.dtype == torch.float32
