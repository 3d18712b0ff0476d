"""The HDC paths' plans over distinct cards, checked on the CPU.

No card is needed and none is touched: ``torch.cuda`` is made to report
1, 2 or 4 cards, and only plans, device lists and counters are built
(no tensor is allocated on a card).  Held here:

* ``plan_executions`` over the visible cards (``local_devices()``, the
  launchers' ``devices=None``) gives the JAX package's device groups
  (``repro.serving.execution._device_groups``) and its rule: a group of
  several cards is sharded where D divides, else pinned to its first
  card.  On 4 cards 2 replicas are two 2-card sharded replicas, on 2
  cards two pinned ones;
* the engine's cards (``engine._stream_devices``: one stream each) and
  its graph device for stand-in models whose shards lie on distinct
  cards, and the order in which a step makes its streams current;
* ``chip_smoke.py``'s plan-derived expectations for its network phases
  (``network_plan``) at 1, 2 and 4 cards;
* the per-card launch counts of ``kernels.ops``.

The distinct-card paths themselves run on a machine with several cards:
``python -m pytest -m cuda tests/test_torch_sharded_cards.py``.
"""

from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.serving import DeviceExecution, ServingEngine, ShardedExecution, plan_executions
from repro_torch.serving import engine as engine_mod

try:  # the JAX package's pure grouping rule
    from repro.serving.execution import _device_groups as jax_device_groups
except ModuleNotFoundError:
    jax_device_groups = None

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def visible(monkeypatch):
    """Make ``torch.cuda`` report `n` cards (no allocation follows)."""

    def show(n: int) -> list[torch.device]:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        return [torch.device("cuda", i) for i in range(n)]

    return show


def _cards(execution) -> list[int]:
    if isinstance(execution, ShardedExecution):
        return [d.index for d in execution.mesh.devices.flat]
    return [execution.device.index]


@pytest.mark.parametrize("n_cards", [1, 2, 4])
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_plan_over_the_visible_cards_gives_jax_groups(visible, n_cards, replicas):
    if jax_device_groups is None:
        pytest.skip("needs the JAX package")
    visible(n_cards)
    execs = plan_executions(8192, replicas=replicas)  # devices=None: every visible card
    assert len(execs) == replicas
    if replicas == 1:  # one replica runs on the first card, in both packages
        assert [_cards(e) for e in execs] == [[0]]
        assert isinstance(execs[0], DeviceExecution)
        return
    groups = jax_device_groups(list(range(n_cards)), replicas)
    for e, group in zip(execs, groups):
        sharded = len(group) > 1 and 8192 % len(group) == 0
        assert isinstance(e, ShardedExecution if sharded else DeviceExecution)
        assert _cards(e) == (group if sharded else group[:1])


def test_two_replicas_on_four_cards_are_two_two_card_sharded_replicas(visible):
    visible(4)
    a, b = plan_executions(8192, replicas=2)
    assert isinstance(a, ShardedExecution) and isinstance(b, ShardedExecution)
    assert (_cards(a), _cards(b)) == ([0, 1], [2, 3])
    assert a.describe()["devices"] == ["cuda:0", "cuda:1"]


def test_two_replicas_on_two_cards_are_pinned(visible):
    visible(2)
    execs = plan_executions(8192, replicas=2)
    assert [type(e) for e in execs] == [DeviceExecution, DeviceExecution]
    assert [_cards(e) for e in execs] == [[0], [1]]


def _stand_in(devices: list[str] | str):
    """A placed model's layout: shards on `devices`, the first the output;
    one device (a str) is a model without shards."""
    if isinstance(devices, str):
        return SimpleNamespace(device=torch.device(devices))
    shards = [SimpleNamespace(device=torch.device(d)) for d in devices]
    return SimpleNamespace(device=shards[0].device, shards=shards)


@pytest.mark.parametrize("devices, cards, graph", [
    ("cuda:3", ["cuda:3"], "cuda:3"),
    (["cuda:1"], ["cuda:1"], "cuda:1"),
    (["cuda:0"] * 4, ["cuda:0"], "cuda:0"),
    (["cuda:0", "cuda:1"], ["cuda:0", "cuda:1"], None),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], ["cuda:0", "cuda:1", "cuda:2", "cuda:3"], None),
    (["cuda:2", "cuda:3", "cuda:2", "cuda:3"], ["cuda:2", "cuda:3"], None),
    (["cpu"] * 4, [], None),
], ids=["unsharded", "one-card", "four-shards-of-one-card", "two-cards", "four-cards",
        "repeated-pair", "cpu"])
def test_engine_streams_one_a_card_and_a_graph_only_on_one_card(devices, cards, graph):
    model = _stand_in(devices)
    assert [str(d) for d in engine_mod._stream_devices(model)] == cards
    got = engine_mod._graph_device(model)
    assert (None if got is None else str(got)) == graph


def test_a_step_makes_every_stream_current_with_the_output_card_last(monkeypatch):
    entered = []

    @contextlib.contextmanager
    def stream(s):
        entered.append(s)
        yield

    monkeypatch.setattr(torch.cuda, "stream", stream)
    engine = ServingEngine.__new__(ServingEngine)
    engine.streams = ["out", "shard1", "shard2"]  # the output card's stream first
    with engine._on_stream():
        pass
    assert entered == ["shard2", "shard1", "out"]


def test_a_cpu_engine_owns_no_stream():
    from repro_torch.core import HDCConfig, HDCModel

    model = HDCModel.create(HDCConfig(n_features=8, n_classes=3, d=64), device="cpu")
    engine = ServingEngine(model, batch_size=4, execution=ShardedExecution(devices=["cpu"] * 2))
    assert engine.streams == [] and engine.stream is None
    assert engine.predict(torch.zeros(4, 8).numpy()).shape == (4,)


@pytest.mark.parametrize("n_cards", [1, 2, 4])
def test_chip_smoke_network_phases_follow_the_plan(visible, n_cards):
    cards = visible(n_cards)
    smoke = _chip_smoke()
    pool = smoke.network_plan("serve_http_pool", plan_executions, cards)
    agg = smoke.network_plan("obs_agg", plan_executions, cards)
    single = smoke.network_plan("serve_http", plan_executions, cards)
    baseline = ("encode_unary_mxu", "bundle_binarize")
    # one engine on the first card: as on the one-card machine
    assert single["replicas"] == [["cuda:0"]] and single["graphs"] == [True]
    assert "hamming_topk" in single["kernels"] and "hamming_packed" in single["absent"]
    if n_cards == 4:  # two 2-card sharded replicas: hamming_packed, no graph
        assert pool["replicas"] == [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]
        assert pool["graphs"] == [False, False]
        assert "hamming_packed" in pool["kernels"] and "hamming_packed" not in pool["absent"]
        assert "hamming_topk" not in pool["kernels"] + pool["absent"]
        assert agg["replicas"] == [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"], ["cuda:0"]]
        assert agg["graphs"] == [False, False, True]
        assert {"hamming_packed", "hamming_topk"} <= set(agg["kernels"])
    else:  # two pinned replicas: cuda:0 twice on one card, cuda:0 and cuda:1 on two
        want = [["cuda:0"], ["cuda:0"]] if n_cards == 1 else [["cuda:0"], ["cuda:1"]]
        assert pool["replicas"] == want and pool["graphs"] == [True, True]
        assert agg["replicas"] == want + [["cuda:0"]] and agg["graphs"] == [True] * 3
        for plan in (pool, agg):
            assert "hamming_topk" in plan["kernels"] and "hamming_packed" in plan["absent"]
    for plan in (pool, agg, single):
        assert set(baseline) <= set(plan["absent"])
        assert not set(plan["kernels"]) & set(plan["absent"])
    if n_cards == 1:  # the checks the one-card network phases made before the plan
        assert set(pool["kernels"]) == {"encode_bundle", "encode_bundle_dynamic", "fit_bundle",
                                        "hamming_topk"}
        assert set(pool["absent"]) == {"fit_bundle_dynamic", "hamming_packed"} | set(baseline)
        assert set(agg["kernels"]) == {"encode_bundle", "fit_bundle", "hamming_topk"}


def test_plan_held_reads_each_engine_against_the_plan():
    smoke = _chip_smoke()
    plan = {"replicas": [["cuda:0", "cuda:1"], ["cuda:2"]], "graphs": [False, True]}

    def engine(execution, graph, replays):
        return SimpleNamespace(n_replays=replays, describe=lambda: {
            "execution": execution, "graph": graph})

    sharded = {"placement": "sharded", "devices": ["cuda:0", "cuda:1"]}
    pinned = {"placement": "device", "device": "cuda:2"}
    assert smoke.plan_held(plan, [engine(sharded, False, 0), engine(pinned, True, 3)])
    assert not smoke.plan_held(plan, [engine(sharded, False, 0), engine(pinned, True, 0)])
    assert not smoke.plan_held(plan, [engine(pinned, True, 3), engine(sharded, False, 0)])


def test_launches_are_counted_by_card():
    before = ({k: v for k, v in ops.LAUNCHES.items()},
              {k: dict(v) for k, v in ops.LAUNCH_SHAPES.items()},
              {k: dict(v) for k, v in ops.LAUNCH_CARDS.items()})
    try:
        ops.reset_launches()
        with ops.recording() as captured:
            ops._launched("hamming_packed", torch.device("cuda", 2), B=4, C=3, W=2, path="warp")
        assert captured == [("hamming_packed", "B=4 C=3 W=2 path=warp", 2)]
        assert ops.LAUNCHES["hamming_packed"] == 0  # a capture counts nothing
        ops.add_launches(captured * 2 + [("hamming_packed", "B=4 C=3 W=2 path=warp", 0)])
        assert ops.LAUNCHES["hamming_packed"] == 3
        assert ops.LAUNCH_CARDS["hamming_packed"] == {2: 2, 0: 1}
        assert ops.LAUNCH_SHAPES["hamming_packed"] == {"B=4 C=3 W=2 path=warp": 3}
        assert _chip_smoke().launches_by_card(ops) == {"hamming_packed": {"0": 1, "2": 2}}
        ops.reset_launches()
        assert ops.LAUNCH_CARDS["hamming_packed"] == {}
    finally:
        ops.LAUNCHES.update(before[0])
        for counts, kept in zip((ops.LAUNCH_SHAPES, ops.LAUNCH_CARDS), before[1:]):
            for k, v in kept.items():
                counts[k].clear()
                counts[k].update(v)


def test_train_hdc_fit_clock_waits_for_every_card_of_the_mesh(monkeypatch):
    from repro_torch.launch import train_hdc

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(str(dev)))
    train_hdc._sync([torch.device("cuda", i) for i in (0, 1, 0, 2, 3, 1)] + [torch.device("cpu")])
    assert synced == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
