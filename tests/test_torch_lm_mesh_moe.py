"""The port's MoE archs over a mesh of 4 gloo processes against the JAX
package, on the CPU: olmoe-1b-7b and moonshot-v1-16b-a3b at smoke width
(8 experts, top-2) on the (2, 2) ``data x model`` mesh
(``torch_lm_mesh_common``'s ranks, ``ShardingRules(fsdp=True)``; the
checks and their tolerances are in ``torch_lm_mesh_checks``; the (1, 4)
mesh is ``test_torch_lm_mesh_moe_1x4.py``).  The experts lie over ``model``: each rank
dispatches its batch shard's tokens and exchanges them with the experts'
owners by two all-to-alls a layer (``moe._moe_ffn_exchange``), as JAX's
``shard_map`` does.

* Every leaf is a ``DTensor`` with the rules' placements, and each rank's
  shard is JAX's addressable shard (the experts' ``mlp`` dim on ``model``,
  as JAX's rules order the logical axes).
* The loss, its ce and aux terms and the gradients equal JAX's
  ``loss_fn`` under the same 4-device mesh: the local dispatch routes each
  batch shard with the capacity of its own tokens and averages the
  shards' aux losses, so the one-device step is not the reference.
* Capacity drops (``moe_capacity=0.5``) on a 4 x 32 batch, whose batch
  shards route 64 tokens each (past the capacity floor of 16), on the
  local dispatch and on ``moe_impl="gspmd"`` (the tokens gathered, routed
  once, each expert on its owner): each equal to JAX's under its mesh, and
  each apart from the dropless dispatch of the same batch.
* 3 AdamW steps equal the port's one-device run under a CPU mesh of the
  ranks' shape (the same per-shard dispatch); the served tokens equal
  JAX's off near-ties; the checkpoint is the one-device save, restored by
  JAX; ZeRO moments and host copies as for the dense archs.
* The collectives of one forward and backward on the (2, 2) mesh (a
  ``fake`` group in this process): two all-to-alls over ``model`` a layer
  each way, each of the (M, E / M, C, D) dispatch buffer.  Experts that do
  not divide ``model`` take JAX's gspmd dispatch with every expert on every
  rank (held to JAX on the (1, 4) mesh in ``test_torch_lm_mesh_moe_1x4.py``).
"""

from __future__ import annotations

import pytest

import torch_lm_mesh_checks as checks
import torch_lm_mesh_common as common

ARCHS = ["olmoe-1b-7b", "moonshot-v1-16b-a3b"]
#: (arch, model_parallel) cases, on the (2, 2) mesh
CASES = [(a, 2) for a in ARCHS]
DROPS = ["drops", "drops_gspmd"]
WIDE = [*DROPS, "dropless_wide"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{2: (the ranks' output directory, JAX's shard slices, the directory
    of JAX's losses and gradients under that mesh)}; the JAX process runs
    beside the ranks."""
    base = tmp_path_factory.mktemp("moe")
    jax_dir = base / "jax"
    jax_dir.mkdir()
    cases = [(a, None) for a in ARCHS] + [(a, v) for a in ARCHS for v in WIDE]
    jax_proc = common.start_jax_shards(ARCHS, common.mesh_shape(2), loss_cases=cases,
                                       out=jax_dir)
    out = common.ranks_done(common.start_ranks(ARCHS, base / "mp2", variant=WIDE), base / "mp2")
    return {2: (out, common.jax_shards(jax_proc), jax_dir)}


@pytest.mark.parametrize("arch,mp", CASES)
def test_every_leaf_is_a_dtensor_with_the_rules_placements(run, arch, mp):
    checks.placements(run[mp][0], arch)


@pytest.mark.parametrize("arch,mp", CASES)
def test_each_rank_holds_its_jax_addressable_shard(run, arch, mp):
    checks.shards(run[mp][0], run[mp][1], arch)


@pytest.mark.parametrize("arch,mp", CASES)
def test_sharded_loss_aux_and_gradients_equal_jax_under_its_mesh(run, arch, mp):
    checks.loss_and_grads_on_mesh(run[mp][0], run[mp][2], arch)


@pytest.mark.parametrize("variant", WIDE)
@pytest.mark.parametrize("arch", ARCHS)
def test_wide_batch_with_and_without_drops_equals_jax_under_its_mesh(run, arch, variant):
    checks.loss_and_grads_on_mesh(run[2][0], run[2][2], arch, variant)


@pytest.mark.parametrize("variant", DROPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_change_the_loss_and_gradients(run, arch, variant):
    """The drop cases drop: their loss and gradients are not the dropless
    dispatch's of the same batch, in the port and in JAX alike."""
    import json

    import numpy as np

    out, _, jax_dir = run[2]
    drop, free = (checks.jax_on_mesh(jax_dir, arch, v) for v in (variant, "dropless_wide"))
    assert abs(drop[0] - free[0]) > 1e-3, (drop[0], free[0])
    got = [json.loads((out / f"{arch}.{v}.rank0.json").read_text())["loss"]
           for v in (variant, "dropless_wide")]
    assert abs(got[0] - got[1]) > 1e-3, got
    grads = [checks._full(out, f"{arch}.{v}") for v in (variant, "dropless_wide")]
    assert max(float(np.abs(grads[0][k] - grads[1][k]).max()) for k in grads[0]) > 1e-3


@pytest.mark.parametrize("arch,mp", CASES)
def test_three_sharded_adamw_steps_equal_the_one_device_run(run, arch, mp):
    checks.train_steps(run[mp][0], arch, per_shard=True)


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


def _meta_mesh(shape):
    import numpy as np

    from repro_torch.distributed.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(["meta"] * n, dtype=object).reshape(shape), ("data", "model"),
                ranks=np.arange(n).reshape(shape))


def test_each_moe_layer_exchanges_its_tokens_by_two_all_to_alls_over_model_each_way():
    """olmoe-1b-7b's smoke loss and its backward on the (2, 2) mesh of a
    4-rank ``fake`` group (rank 0's part, ``meta`` shards), batch 4 x 32:
    each rank routes its 2 x 32 tokens with capacity 128 (the smoke
    config's capacity factor 8) and exchanges the (2, 4, 128, 64) buffer
    over ``model``, out and back, in each of the 2 layers; the backward
    sends the gradients the same two ways."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (
        ShardingRules,
        abstract_params,
        mesh_ops,
        model_group,
    )
    from repro_torch.launch.dryrun import CollectiveCounter, _dtensor_inputs, fake_group
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves

    class Exchanges(CollectiveCounter):
        def __init__(self):
            super().__init__()
            self.seen: list[tuple] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops._c10d_functional.all_to_all_single.default:
                self.seen.append((tuple(args[0].shape), args[3]))
            return super().__torch_dispatch__(func, types, args, kwargs)

    cfg = get_smoke_config("olmoe-1b-7b")
    with fake_group(4):
        mesh = _meta_mesh((2, 2))
        dm = mesh.device_mesh()
        params = _dtensor_inputs(abstract_params(cfg, mesh, ShardingRules(**common.RULES_KW)),
                                 mesh)
        for t in tree_leaves(params):
            t.requires_grad_()
        tokens = DTensor.from_local(torch.zeros(2, 32, dtype=torch.int32, device="meta"), dm,
                                    [Shard(0), Replicate()], run_check=False,
                                    shape=torch.Size((4, 32)), stride=(32, 1))
        model = model_group(dm).group_name
        fwd, bwd = Exchanges(), Exchanges()
        with fwd:
            loss, _ = transformer.loss_fn(cfg, params, {"tokens": tokens})
        with mesh_ops(params), bwd:
            loss.backward()
    want = [((2, 4, 128, 64), model)] * (2 * cfg.n_layers)
    assert fwd.seen == want and bwd.seen == want
    assert all(t.grad is not None for t in tree_leaves(params))


def test_experts_that_do_not_divide_the_model_axis_are_all_computed_on_every_rank():
    """8 experts over a model axis of 3 ranks (a ``fake`` group of 3,
    ``meta`` shards): both dispatches take JAX's gspmd path, whose
    ``P("model", …)`` constraint JAX drops, so every rank computes all 8
    experts on the whole batch and no expert output is exchanged."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import ShardingRules, abstract_params
    from repro_torch.launch.dryrun import CollectiveCounter, _dtensor_inputs, fake_group
    from repro_torch.models import moe

    cfg = get_smoke_config("olmoe-1b-7b")
    seen = []
    experts = moe._experts

    def spy(p, xs):
        seen.append(tuple(xs.shape))
        return experts(p, xs)

    with fake_group(3):
        mesh = _meta_mesh((1, 3))
        params = _dtensor_inputs(abstract_params(cfg, mesh, ShardingRules()), mesh)
        p = {k: v[0] for k, v in params["blocks"]["sub0"]["moe"].items()}
        x = DTensor.from_local(torch.empty(2, 8, 64, device="meta"), mesh.device_mesh(),
                               [Replicate(), Replicate()], run_check=False)
        moe._experts = spy
        try:
            for impl in ("local", "gspmd"):
                counter = CollectiveCounter()
                with counter:
                    y, aux = moe.moe_ffn(dataclasses.replace(cfg, moe_impl=impl), p, x)
                assert tuple(y.shape) == (2, 8, 64) and aux.shape == ()
                assert counter.counts["all-to-all"] == counter.counts["all-gather"] == 0
        finally:
            moe._experts = experts
    assert [s[0] for s in seen] == [8, 8]
