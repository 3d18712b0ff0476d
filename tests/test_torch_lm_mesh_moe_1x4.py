"""olmoe-1b-7b at smoke width over the (1, 4) ``data x model`` mesh of 4
gloo processes against the JAX package, on the CPU: its 8 experts two a
rank, every rank holding the whole batch, so that each owner receives 4
copies of the same dispatch buffer (``test_torch_lm_mesh_moe.py`` has the
(2, 2) mesh and states the checks; ``torch_lm_mesh_checks`` their
tolerances).  In the same run, two layouts that do not divide the model
axis of 4, where JAX's ``constrain`` drops ``model`` and GSPMD keeps the
dimension whole on it: 6 experts (JAX's gspmd dispatch, every rank
computing all of them) and 6 query heads, 2 kv heads and head_dim 6
(every rank attending with all heads); and the same heads with head_dim 8,
which attend on head_dim shards, their partial scores all-reduced and
their output projected per shard.  Each is held to JAX's loss and
gradients under the same mesh, from weights drawn for its shapes."""

from __future__ import annotations

import pytest

import torch_lm_mesh_checks as checks
import torch_lm_mesh_common as common

ARCH = "olmoe-1b-7b"
#: the config variants that do not divide ``model`` (``torch_lm_mesh_common.VARIANTS``)
UNDIVIDED = ["experts6", "heads6", "heads6_hd8"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' output directory, JAX's shard slices, the directory of
    JAX's loss and gradients under the (1, 4) mesh)."""
    base = tmp_path_factory.mktemp("moe14")
    jax_dir = base / "jax"
    jax_dir.mkdir()
    cases = [(ARCH, None)] + [(ARCH, v) for v in UNDIVIDED]
    jax_proc = common.start_jax_shards([ARCH], common.mesh_shape(4), loss_cases=cases,
                                       out=jax_dir)
    out = common.ranks_done(common.start_ranks([ARCH], base / "mp4", model_parallel=4,
                                               variant=UNDIVIDED), base / "mp4")
    return out, common.jax_shards(jax_proc), jax_dir


def test_every_leaf_is_a_dtensor_with_the_rules_placements(run):
    checks.placements(run[0], ARCH)


def test_each_rank_holds_its_jax_addressable_shard(run):
    checks.shards(run[0], run[1], ARCH)


def test_sharded_loss_aux_and_gradients_equal_jax_under_its_mesh(run):
    checks.loss_and_grads_on_mesh(run[0], run[2], ARCH)


def test_three_sharded_adamw_steps_equal_the_one_device_run(run):
    checks.train_steps(run[0], ARCH, per_shard=True)


def test_sharded_served_tokens_equal_jax_off_near_ties(run):
    checks.served_tokens(run[0], ARCH)


def test_sharded_checkpoint_is_the_one_device_save_and_jax_restores_it(run, tmp_path):
    checks.checkpoint(run[0], ARCH, tmp_path)


def test_adamw_with_zero_moments_equals_moments_laid_out_as_params(run):
    checks.zero_moments(run[0], ARCH)


def test_only_rank_0_copies_the_checkpoint_to_host_memory(run):
    checks.host_copies(run[0], ARCH)


@pytest.mark.parametrize("variant", UNDIVIDED)
def test_layouts_that_do_not_divide_model_run_and_equal_jax_under_its_mesh(run, variant):
    checks.loss_and_grads_on_mesh(run[0], run[2], ARCH, variant)
