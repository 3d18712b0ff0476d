"""The port's LM paths over a mesh of 4 gloo processes against the JAX
package's one-device step, on the CPU: qwen3-0.6b and qwen3-32b at smoke
width (``torch_lm_mesh_common``'s ranks on a (2, 2) ``data x model`` mesh,
``ShardingRules(fsdp=True)``; the checks and their tolerances are in
``torch_lm_mesh_checks``), and qwen3-0.6b once more on the (1, 4) mesh,
where its 2 kv heads do not divide ``model`` and wk / wv are sharded on
their head_dim (``attention._proj_per_shard``) and attention gathers the
kv heads (train) or shards head_dim (decode).  The gradients hold under
the per-block remat with the "dots" policy too."""

from __future__ import annotations

import json

import pytest

import torch_lm_mesh_checks as checks
import torch_lm_mesh_common as common

ARCHS = ["qwen3-0.6b", "qwen3-32b"]
#: (arch, model_parallel) cases: the (2, 2) mesh for both, and (1, 4)
CASES = [(a, 2) for a in ARCHS] + [("qwen3-0.6b", 4)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{model_parallel: (the ranks' output directory, JAX's shard slices)}.
    The two 4-rank jobs run one after the other, to keep the suite's other
    workers their share of the cores."""
    base = tmp_path_factory.mktemp("mesh")
    jax_procs = {2: common.start_jax_shards(ARCHS, common.mesh_shape(2)),
                 4: common.start_jax_shards(ARCHS[:1], common.mesh_shape(4))}
    out = {2: common.ranks_done(common.start_ranks(ARCHS, base / "mp2", variant="remat_dots"),
                                base / "mp2")}
    out[4] = common.ranks_done(common.start_ranks(ARCHS[:1], base / "mp4", model_parallel=4,
                                                  variant="blocked"), base / "mp4")
    return {mp: (out[mp], common.jax_shards(jax_procs[mp])) for mp in out}


@pytest.mark.parametrize("arch,mp", CASES)
def test_every_leaf_is_a_dtensor_with_the_rules_placements(run, arch, mp):
    checks.placements(run[mp][0], arch)


@pytest.mark.parametrize("arch,mp", CASES)
def test_each_rank_holds_its_jax_addressable_shard(run, arch, mp):
    checks.shards(run[mp][0], run[mp][1], arch)


@pytest.mark.parametrize("arch,mp", CASES)
def test_sharded_loss_and_gradients_equal_jax(run, arch, mp):
    checks.loss_and_grads(run[mp][0], arch)


@pytest.mark.parametrize("arch,mp", CASES)
def test_three_sharded_adamw_steps_equal_the_one_device_run(run, arch, mp):
    checks.train_steps(run[mp][0], arch)


@pytest.mark.parametrize("arch,mp", CASES)
def test_sharded_served_tokens_equal_jax_off_near_ties(run, arch, mp):
    checks.served_tokens(run[mp][0], arch)


@pytest.mark.parametrize("arch,mp", CASES)
def test_sharded_checkpoint_is_the_one_device_save_and_jax_restores_it(run, arch, mp, tmp_path):
    checks.checkpoint(run[mp][0], arch, tmp_path)


@pytest.mark.parametrize("arch,mp", CASES)
def test_adamw_with_zero_moments_equals_moments_laid_out_as_params(run, arch, mp):
    checks.zero_moments(run[mp][0], arch)


@pytest.mark.parametrize("arch,mp", CASES)
def test_only_rank_0_copies_the_checkpoint_to_host_memory(run, arch, mp):
    checks.host_copies(run[mp][0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grads_under_per_block_remat_with_the_dots_policy_equal_jax(run, arch):
    checks.loss_and_grads(run[2][0], arch, "remat_dots")


def test_sharded_grads_through_the_blocked_online_softmax_with_the_kv_heads_gathered(run):
    """The (1, 4) mesh: each rank's one query head reads one gathered kv
    head in 8-wide blocks over 16 positions."""
    checks.loss_and_grads(run[4][0], "qwen3-0.6b", "blocked")


@pytest.mark.parametrize("t,layout", [(16, "kv heads gathered"), (1, "head_dim"),
                                      (1, "kv heads gathered")])
def test_attention_over_a_model_axis_the_kv_heads_do_not_divide_computes_no_head_twice(
        t, layout):
    """``attention._per_shard`` on a (1, 4) mesh of a 4-rank ``fake`` group
    (rank 0's part, ``meta`` shards) for qwen3-0.6b's smoke heads (4 query,
    2 kv, head_dim 16): with 16 query rows (train) each rank gets its one
    query head and the one kv head it reads, gathered; with one query row
    (decode) each rank gets a quarter of head_dim of every head and
    all-reduces its partial scores once; at decode with a head_dim of 6,
    which the axis does not divide, the kv heads are gathered as in train."""
    import dataclasses

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.dryrun import CollectiveCounter, fake_group
    from repro_torch.models import attention

    hd = 6 if (t, layout) == (1, "kv heads gathered") else 16
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), head_dim=hd)
    seen = {}

    def fn(c, q, k, v, psum):
        seen.update(cfg=c, q=tuple(q.shape), k=tuple(k.shape), v=tuple(v.shape))
        if psum is not None:
            seen["scores"] = tuple(psum(torch.empty(2, 2, 2, t, 8, device="meta")).shape)
        return torch.empty(q.shape[0], t, c.n_heads, v.shape[-1], device="meta")

    with fake_group(4):
        mesh = Mesh(np.array(["meta"] * 4, dtype=object).reshape(1, 4), ("data", "model"),
                    ranks=np.arange(4).reshape(1, 4))
        dm = mesh.device_mesh()

        def whole(*shape):
            return DTensor.from_local(torch.empty(shape, device="meta"), dm,
                                      [Replicate(), Replicate()], run_check=False)

        counter = CollectiveCounter()
        with counter:
            out = attention._per_shard(cfg, fn, whole(2, t, 4, hd), whole(2, 8, 2, hd),
                                       whole(2, 8, 2, hd))
    assert tuple(out.shape) == (2, t, 4, hd)
    if layout == "head_dim":
        assert seen["q"] == (2, 1, 4, 4) and seen["k"] == seen["v"] == (2, 8, 2, 4)
        assert (seen["cfg"].n_heads, seen["cfg"].n_kv_heads) == (4, 2)
        assert seen["scores"] == (2, 2, 2, 1, 8) and counter.counts["all-reduce"] == 1
        assert out.placements[1] == Shard(3)
    else:
        assert seen["q"] == (2, t, 1, hd) and seen["k"] == seen["v"] == (2, 8, 1, hd)
        assert (seen["cfg"].n_heads, seen["cfg"].n_kv_heads) == (1, 1)
        assert "scores" not in seen and counter.counts["all-reduce"] == 0
        assert out.placements[1] == Shard(2)


def test_kv_heads_that_do_not_divide_model_are_sharded_on_head_dim(run):
    rec = json.loads((run[4][0] / "qwen3-0.6b.rank0.json").read_text())
    assert rec["mesh"] == {"data": 1, "model": 4}
    for name in ("wk", "wv"):
        assert rec["leaves"][f"blocks/sub0/mixer/{name}"]["placements"][1] == "S(3)"

