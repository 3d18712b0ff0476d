"""The port's remaining LM archs over a mesh of 4 gloo processes against the
JAX package, on the CPU: recurrentgemma-2b (RG-LRU), xlstm-1.3b (mLSTM and
sLSTM), llama-3.2-vision-90b (gated cross-attention to a context) and
musicgen-medium (frame embeddings as input) at smoke width, in one run of
``torch_lm_mesh_common``'s ranks on the (2, 2) ``data x model`` mesh
(``ShardingRules(fsdp=True)``; the checks and their tolerances are in
``torch_lm_mesh_checks``).  The recurrent mixers run on each rank's batch
shard and its channels or heads (``models.per_shard``), cross-attention
through ``attention._per_shard``.

* Every leaf is a ``DTensor`` with the rules' placements, and each rank's
  shard is JAX's addressable shard.
* The loss and gradients equal JAX's ``loss_fn`` under the same 4-device
  mesh (computed beside the ranks, ``start_jax_shards``).
* 3 AdamW steps equal the port's one-device run; xlstm-1.3b's third
  step, whose gradient is ill-conditioned at smoke width, is also held at
  the params before it against the spread of rounding-scale weight
  changes; the checkpoint is the one-device save, restored by JAX; ZeRO
  moments and host copies as for the dense archs.
* The served tokens of recurrentgemma-2b and xlstm-1.3b equal JAX's
  ``Server``'s off near-ties (the other two fail at the prefill in both
  packages' ``Server``, a request carrying tokens alone), and their decode
  states are laid out by ``decode_state_axes``.

The smoke sequences are short (a loss batch of 2 x 16, train batches of
4 x 32, prompts of 8 and 6 new tokens): the sLSTM loops over its steps.
"""

from __future__ import annotations

import pytest

import torch_lm_mesh_checks as checks
import torch_lm_mesh_common as common
from repro_torch.configs import ARCHS as ALL_ARCHS

ARCHS = ["recurrentgemma-2b", "xlstm-1.3b", "llama-3.2-vision-90b", "musicgen-medium"]
SERVED = ["recurrentgemma-2b", "xlstm-1.3b"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' output directory, JAX's shard slices, the directory of
    JAX's losses and gradients under the (2, 2) mesh)."""
    base = tmp_path_factory.mktemp("rec")
    jax_dir = base / "jax"
    jax_dir.mkdir()
    jax_proc = common.start_jax_shards(ARCHS, common.mesh_shape(2),
                                       loss_cases=[(a, None) for a in ARCHS], out=jax_dir)
    out = common.ranks_done(common.start_ranks(ARCHS, base / "mp2"), base / "mp2")
    return out, common.jax_shards(jax_proc), jax_dir


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_a_dtensor_with_the_rules_placements(run, arch):
    checks.placements(run[0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_jax_addressable_shard(run, arch):
    checks.shards(run[0], run[1], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_equal_jax_under_its_mesh(run, arch):
    checks.loss_and_grads_on_mesh(run[0], run[2], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_sharded_adamw_steps_equal_the_one_device_run(run, arch):
    checks.train_steps(run[0], arch)


@pytest.mark.parametrize("arch", common.LAST_STEP_GRADS)
def test_last_step_gradients_part_from_one_device_no_more_than_rounding_does(run, arch):
    checks.last_step_gradient(run[0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_checkpoint_is_the_one_device_save_and_jax_restores_it(run, arch, tmp_path):
    checks.checkpoint(run[0], arch, tmp_path)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_with_zero_moments_equals_moments_laid_out_as_params(run, arch):
    checks.zero_moments(run[0], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_only_rank_0_copies_the_checkpoint_to_host_memory(run, arch):
    checks.host_copies(run[0], arch)


@pytest.mark.parametrize("arch", SERVED)
def test_sharded_served_tokens_equal_jax_off_near_ties(run, arch):
    checks.served_tokens(run[0], arch)


@pytest.mark.parametrize("arch", SERVED)
def test_recurrent_decode_states_are_laid_out_by_decode_state_axes(run, arch):
    checks.state_layouts(run[0], arch)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_state_axes_mirror_the_decode_state_tree(arch):
    """``decode_state_axes`` has ``init_decode_state``'s tree, one axis name
    a dim of each leaf, for every arch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer

    cfg = get_smoke_config(arch)
    state = common.flat(common.state_tree(transformer.init_decode_state(cfg, 2, 8, device="meta")))
    axes = dict(common.flat(common.state_tree(transformer.decode_state_axes(cfg))))
    assert [k for k, _ in state] == sorted(axes)
    for key, t in state:
        assert len(axes[key]) == t.ndim, (key, axes[key], tuple(t.shape))
