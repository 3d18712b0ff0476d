"""The port's MoE, RG-LRU and xLSTM mixers and the server's random numbers
against the JAX package's, on the CPU.

Each mixer gets the same parameters (JAX's, carried across) and the same
inputs from a seeded numpy generator.  Tolerances: 1e-5 in float32 (the
RG-LRU scan: JAX's associative scan and the port's Hillis-Steele scan
combine in different trees, 1e-5 holds), 5e-2 where bf16 is computed.
``fold_in`` and ``categorical`` are bit-exact.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed import sharding as jsharding
from repro.launch.mesh import mesh_for as jmesh_for
from repro.models import moe as jmoe, params as jparams_mod, recurrent as jrec, xlstm as jxl
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.core import prng
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch.mesh import mesh_for as tmesh_for
from repro_torch.models import moe as tmoe, recurrent as trec, xlstm as txl

TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _mixer(arch: str, sub: str, part: str):
    """Group 0's `sub` layer's `part` subtree ("mixer" or "moe") of JAX's
    smoke params, as (JAX tree, torch tree)."""
    cfg = jget_smoke(arch)
    tree = jax.jit(lambda k: jparams_mod.init_params(cfg, k))(jax.random.PRNGKey(0))
    sub_tree = jax.tree.map(lambda a: np.asarray(a)[0], tree["blocks"][sub][part])
    return (jax.tree.map(jnp.asarray, sub_tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), sub_tree))


def _x(shape, seed=0, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _same(j, t, **tol):
    assert tuple(t.shape) == tuple(j.shape)
    j = j.float().numpy() if isinstance(j, torch.Tensor) else np.asarray(j, np.float32)
    np.testing.assert_allclose(t.float().numpy(), j, **(tol or TOL))


@pytest.fixture
def no_mesh():
    jprev, tprev = jsharding.get_current_mesh(), tsharding.get_current_mesh()
    jsharding.set_current_mesh(None)
    tsharding.set_current_mesh(None)
    yield
    jsharding.set_current_mesh(jprev)
    tsharding.set_current_mesh(tprev)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "olmoe-1b-7b"])
@pytest.mark.parametrize("capacity", [8.0, 0.5])
def test_moe_gspmd_equals_jax(arch, capacity, no_mesh):
    """Capacity 0.5 drops assignments: the drop order must match too."""
    jc = dataclasses.replace(jget_smoke(arch), moe_capacity=capacity)
    tc = dataclasses.replace(tget_smoke(arch), moe_capacity=capacity)
    jp, tp = _mixer(arch, "sub0", "moe")
    for shape in ((2, 12, 64), (4, 1, 64)):  # prefill and a decode step
        jx, tx = _x(shape, 1)
        jy, jaux = jmoe._moe_ffn_gspmd(jc, jp, jx)
        ty, taux = tmoe._moe_ffn_gspmd(tc, tp, tx)
        _same(jy, ty)
        _same(jaux, taux)
        jy, _ = jmoe.moe_ffn(jc, jp, jx)  # no mesh: both take gspmd
        _same(jy, tmoe.moe_ffn(tc, tp, tx)[0])
    jx, tx = _x((2, 12, 64), 2, "bfloat16")
    _same(jmoe._moe_ffn_gspmd(jc, jp, jx)[0], tmoe._moe_ffn_gspmd(tc, tp, tx)[0], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "olmoe-1b-7b"])
def test_moe_local_under_a_one_device_mesh_equals_jax(arch, no_mesh):
    """Both configs set moe_impl="local": under the launchers' one-device
    mesh (data 1, model 1) moe_ffn takes the local dispatch in both."""
    jc, tc = jget_smoke(arch), tget_smoke(arch)
    assert jc.moe_impl == tc.moe_impl == "local"
    jp, tp = _mixer(arch, "sub0", "moe")
    jmesh = jmesh_for(1)
    tmesh = tmesh_for(devices=["cpu"])
    assert dict(jmesh.shape) == tmesh.shape == {"data": 1, "model": 1}
    for shape in ((2, 12, 64), (4, 1, 64)):
        jx, tx = _x(shape, 3)
        jy, jaux = jax.jit(lambda p, x: jmoe._moe_ffn_local(jc, p, x, jmesh))(jp, jx)
        ty, taux = tmoe._moe_ffn_local(tc, tp, tx, tmesh)
        _same(jy, ty)
        _same(jaux, taux)
        jsharding.set_current_mesh(jmesh)
        tsharding.set_current_mesh(tmesh)
        _same(jax.jit(lambda p, x: jmoe.moe_ffn(jc, p, x))(jp, jx)[0], tmoe.moe_ffn(tc, tp, tx)[0])
        jsharding.set_current_mesh(None)
        tsharding.set_current_mesh(None)


def test_moe_local_dispatches_each_batch_shard_on_its_own(no_mesh):
    """On a (data 2, model 2) mesh each half of the batch is routed with the
    capacity of its own tokens: the gspmd dispatch of each half."""
    tc = dataclasses.replace(tget_smoke("olmoe-1b-7b"), moe_capacity=0.5)
    _, tp = _mixer("olmoe-1b-7b", "sub0", "moe")
    mesh = tmesh_for(4, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    _, tx = _x((4, 6, 64), 4)
    y, aux = tmoe._moe_ffn_local(tc, tp, tx, mesh)
    halves = [tmoe._moe_ffn_gspmd(tc, tp, h) for h in tx.split(2)]
    assert torch.equal(y, torch.cat([h[0] for h in halves]))
    assert torch.allclose(aux, (halves[0][1] + halves[1][1]) / 2)
    # a batch the shards do not divide falls back to the global dispatch
    _, tx = _x((3, 6, 64), 5)
    assert torch.equal(tmoe._moe_ffn_local(tc, tp, tx, mesh)[0], tmoe._moe_ffn_gspmd(tc, tp, tx)[0])


def test_moe_dense_oracle_equals_jax_and_the_dropless_dispatch(no_mesh):
    jc, tc = jget_smoke("olmoe-1b-7b"), tget_smoke("olmoe-1b-7b")
    jp, tp = _mixer("olmoe-1b-7b", "sub0", "moe")
    jx, tx = _x((2, 12, 64), 6)
    oracle = tmoe.moe_ffn_dense_oracle(tc, tp, tx)
    _same(jmoe.moe_ffn_dense_oracle(jc, jp, jx), oracle)
    _same(oracle, tmoe._moe_ffn_gspmd(tc, tp, tx)[0])  # capacity 8: drops nothing


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_rglru_pieces_equal_jax():
    jp, tp = _mixer("recurrentgemma-2b", "sub0", "mixer")
    jx, tx = _x((2, 13, 64), 7)
    _same(jrec._conv_causal(jp, jx), trec._conv_causal(tp, tx))
    for jj, tt_ in zip(jrec._lru_coeffs(jp, jx), trec._lru_coeffs(tp, tx)):
        _same(jj, tt_)
    jh0, th0 = _x((2, 64), 8)
    for h0 in (None, (jh0, th0)):
        jy, jl = jrec.rglru_scan(jp, jx, None if h0 is None else h0[0])
        ty, tl = trec.rglru_scan(tp, tx, None if h0 is None else h0[1])
        _same(jy, ty)
        _same(jl, tl)
    jy, jh = jrec.rglru_step(jp, jx[:, :1], jh0)
    ty, th = trec.rglru_step(tp, tx[:, :1], th0)
    _same(jy, ty)
    _same(jh, th)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_block_prefill_and_decode_equal_jax(dtype):
    jc = dataclasses.replace(jget_smoke("recurrentgemma-2b"), compute_dtype=dtype)
    tc = dataclasses.replace(tget_smoke("recurrentgemma-2b"), compute_dtype=dtype)
    jp, tp = _mixer("recurrentgemma-2b", "sub0", "mixer")
    tol = TOL if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
    jblock = {mode: jax.jit(functools.partial(jrec.recurrent_block, jc, mode=mode))
              for mode in ("train", "prefill", "decode")}
    for t in (2, 9):  # a prompt shorter than the conv's history, and longer
        jx, tx = _x((2, t + 3, 64), 9, dtype)
        jy, jst = jblock["prefill"](jp, jx[:, :t])
        ty, tst = trec.recurrent_block(tc, tp, tx[:, :t], mode="prefill")
        _same(jy, ty, **tol)
        jfull, _ = jblock["train"](jp, jx)
        tfull, _ = trec.recurrent_block(tc, tp, tx, mode="train")
        _same(jfull, tfull, **tol)
        for i in range(t, t + 3):
            jy, jst = jblock["decode"](jp, jx[:, i:i + 1], state=jst)
            ty, tst = trec.recurrent_block(tc, tp, tx[:, i:i + 1], mode="decode", state=tst)
            _same(jy, ty, **tol)
            _same(jst["h"], tst["h"], **tol)
            _same(tfull[:, i:i + 1], ty, **tol)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [12, 10, 7])
def test_mlstm_chunkwise_and_step_equal_jax(t):
    """Chunk 4 at smoke size: 12 is whole chunks, 10 falls back to chunks
    of 2 and 7 to chunks of 1 (the largest divisor)."""
    cfg_j, cfg_t = jget_smoke("xlstm-1.3b"), tget_smoke("xlstm-1.3b")
    cfg_j, cfg_t = (dataclasses.replace(c, compute_dtype="float32") for c in (cfg_j, cfg_t))
    jp, tp = _mixer("xlstm-1.3b", "sub0", "mixer")
    jx, tx = _x((2, t + 2, 64), 10)
    jy, jst = jxl.mlstm_chunkwise(cfg_j, jp, jx[:, :t], None, return_state=True)
    ty, tst = txl.mlstm_chunkwise(cfg_t, tp, tx[:, :t], None, return_state=True)
    tol = dict(rtol=1e-4, atol=1e-4)
    _same(jy, ty, **tol)
    for k in ("c", "n", "m"):
        _same(jst[k], tst[k], **tol)
    for i in range(t, t + 2):
        jy, jst = jxl.mlstm_step(cfg_j, jp, jx[:, i:i + 1], jst)
        ty, tst = txl.mlstm_step(cfg_t, tp, tx[:, i:i + 1], tst)
        _same(jy, ty, **tol)
    # the chunkwise form equals the stepwise recurrence
    st = txl.init_mlstm_state(cfg_t, 2)
    steps = []
    for i in range(t):
        y, st = txl.mlstm_step(cfg_t, tp, tx[:, i:i + 1], st)
        steps.append(y)
    _same(txl.mlstm_chunkwise(cfg_t, tp, tx[:, :t], None, return_state=False)[0].numpy(),
          torch.cat(steps, 1), **tol)


def test_slstm_block_equals_jax():
    cfg_j = dataclasses.replace(jget_smoke("xlstm-1.3b"), compute_dtype="float32")
    cfg_t = dataclasses.replace(tget_smoke("xlstm-1.3b"), compute_dtype="float32")
    jp, tp = _mixer("xlstm-1.3b", "sub7", "mixer")
    jx, tx = _x((2, 9, 64), 11)
    jy, _ = jxl.slstm_block(cfg_j, jp, jx, mode="train")
    ty, _ = txl.slstm_block(cfg_t, tp, tx, mode="train")
    _same(jy, ty)
    jy, jst = jxl.slstm_block(cfg_j, jp, jx[:, :7], mode="prefill")
    ty, tst = txl.slstm_block(cfg_t, tp, tx[:, :7], mode="prefill")
    _same(jy, ty)
    for i in range(7, 9):
        jy, jst = jxl.slstm_block(cfg_j, jp, jx[:, i:i + 1], jst, mode="decode")
        ty, tst = txl.slstm_block(cfg_t, tp, tx[:, i:i + 1], tst, mode="decode")
        _same(jy, ty)
        for k in ("c", "n", "m", "h"):
            _same(jst[k], tst[k])
    init_j = jxl.init_slstm_state(cfg_j, 3)
    init_t = txl.init_slstm_state(cfg_t, 3)
    for k in init_j:
        _same(init_j[k], init_t[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The server's random numbers
# ---------------------------------------------------------------------------


def test_fold_in_is_bit_exact():
    assert jax.config.jax_threefry_partitionable
    for seed in (0, 1, 7, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        ours = prng.prng_key(seed)
        for data in (0, 1, 5, 127, 2**31 + 3, 2**32 - 1):
            want = np.asarray(jax.random.fold_in(key, data))
            assert np.array_equal(prng.fold_in(ours, data), want), (seed, data)
        # a chain of folds, as the server walks it
        for i in range(20):
            key, ours = jax.random.fold_in(key, i), prng.fold_in(ours, i)
        assert np.array_equal(ours, np.asarray(key))


@pytest.mark.parametrize("shape", [(4, 512), (2, 3, 128), (1, 151_936)])
def test_categorical_is_bit_exact(shape):
    assert jax.config.jax_threefry_partitionable
    rng = np.random.default_rng(12)
    tiny = float(np.finfo(np.float32).tiny)
    for draw in range(8):
        key = jax.random.fold_in(jax.random.PRNGKey(1), draw)
        logits = (rng.standard_normal(shape) * 3).astype(np.float32) / np.float32(0.7)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
        got = prng.categorical(np.asarray(key), torch.from_numpy(logits))
        assert np.array_equal(got.numpy(), want)
        # the uniform under the Gumbel noise is the same bits
        u = np.asarray(jax.random.uniform(key, shape, minval=tiny, maxval=1.0))
        assert np.array_equal(prng.uniform(np.asarray(key), shape, minval=tiny, maxval=1.0), u)
