"""The port's LM paths over a mesh of 4 gloo processes against the JAX
package's one-device step, on the CPU: gemma-7b and gemma3-12b at smoke
width (``torch_lm_mesh_common``'s ranks on a (2, 2) ``data x model`` mesh,
``ShardingRules(fsdp=True)``; the checks and their tolerances are in
``torch_lm_mesh_checks``), and their gradients through the blocked
online-softmax attention."""

from __future__ import annotations

import pytest

import torch_lm_mesh_checks as checks
import torch_lm_mesh_common as common

ARCHS = ["gemma-7b", "gemma3-12b"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jax_proc = common.start_jax_shards(ARCHS)
    out = tmp_path_factory.mktemp("mesh")
    out = common.ranks_done(common.start_ranks(ARCHS, out, variant="blocked"), out)
    return out, common.jax_shards(jax_proc)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_a_dtensor_with_the_rules_placements(run, arch):
    checks.placements(run[0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_jax_addressable_shard(run, arch):
    checks.shards(run[0], run[1], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_equal_jax(run, arch):
    checks.loss_and_grads(run[0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_sharded_adamw_steps_equal_the_one_device_run(run, arch):
    checks.train_steps(run[0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_served_tokens_equal_jax_off_near_ties(run, arch):
    checks.served_tokens(run[0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_checkpoint_is_the_one_device_save_and_jax_restores_it(run, arch, tmp_path):
    checks.checkpoint(run[0], arch, tmp_path)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grads_through_the_blocked_online_softmax_equal_jax(run, arch):
    """8-wide query and kv blocks over 16 positions, some wholly masked
    (gemma3's 8-wide window too), the heads over ``model``."""
    checks.loss_and_grads(run[0], arch, "blocked")
