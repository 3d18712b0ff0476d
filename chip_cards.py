#!/usr/bin/env python3
"""Drive the HDC paths on every visible card (at most 4) and check them.

    python3 chip_cards.py        # from the repository root, on a machine with one or more cards

The distinct-card subset of ``chip_smoke.py``, through its phase functions and
in its order, without the kernel timings and the LM phases: the ``uhd``
serving smoke (``slice_uhd``, whose checkpoint the pools reload), the 64 MiB
item memory, the sharded phases of the three encoders at D = 8192 (which write
the per-host shards), ``sharded_search``, ``train_shard_map`` (``train_hdc
--shard-map`` over ``mesh_for()`` of every visible card), ``sharded_cards`` over
N = min(cards, 4) distinct cards, ``serve_pool``, the five network phases (their replicas
planned over every visible card, their checks derived from that plan), and
``profile`` of the 4-shard engines on cuda:0 and, with several cards, of the
same engines over the N cards.  One JSON object a line (``chip_smoke.emit``),
the ``nvidia-smi`` line of each card, then ``{"ok": true, "device": {...}}``.
Any failed check raises and exits non-zero.  On one card every check runs on
that card (``sharded_cards`` then prints ``cards: 1``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_cards: no CUDA device; this script runs on a card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as c
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import HDCConfig, HDCModel, ItemMemory, partial_fit_sharded
    from repro_torch.data import load_dataset
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import obs_agg, serve_hdc, serve_http, serve_online, train_hdc
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.serving import (
        DeviceExecution, ModelRegistry, ServingEngine, ShardedExecution,
    )

    api = SimpleNamespace(
        CheckpointManager=CheckpointManager, DeviceExecution=DeviceExecution,
        HDCConfig=HDCConfig, HDCModel=HDCModel, ModelRegistry=ModelRegistry,
        ServingEngine=ServingEngine, ShardedExecution=ShardedExecution,
        load_dataset=load_dataset, mesh_for=mesh_for, partial_fit_sharded=partial_fit_sharded,
    )
    t0 = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    c.emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
           cuda=torch.version.cuda)
    _build.library()
    c.emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_info["seconds"])

    dev = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(min(count, 4))]
    _, result_uhd = c.slice_phase(
        torch, ops, serve_hdc, load_dataset, "uhd",
        ("encode_bundle", "fit_bundle", "hamming_topk", "encode_bundle_dynamic"),
    )
    _, stored = c.item_memory_phase(torch, ops, ref, ItemMemory)
    shard_engines = {}
    for encoder in ("uhd_dynamic", "uhd", "baseline"):
        _, shard_engines[encoder] = c.sharded_phase(torch, ops, api, encoder, 8192, dev)
    c.sharded_search_phase(torch, ops, api, result_uhd.models[1], result_uhd.probe, stored, dev)
    c.train_shard_map_phase(torch, ops, train_hdc)
    _, cards_engines = c.sharded_cards_phase(torch, ops, api, result_uhd, stored, cards)
    c.serve_pool_phase(torch, ops, api, result_uhd, dev)
    t_net = time.perf_counter()
    c.serve_http_phase(torch, ops, serve_http, replicas=1)
    c.serve_http_phase(torch, ops, serve_http, replicas=2)
    for encoder in ("uhd", "uhd_dynamic"):
        c.serve_online_phase(torch, ops, serve_online, encoder)
    c.obs_agg_phase(torch, ops, obs_agg)
    c.emit("network_phases", seconds=time.perf_counter() - t_net)
    probe = result_uhd.probe[:64]
    for encoder, engine in shard_engines.items():
        c.profile_phase(torch, engine, probe, f"{encoder}, 4 shards")
    if len(cards) > 1:
        for encoder, engine in cards_engines.items():
            c.profile_phase(torch, engine, probe, f"{encoder}, {len(cards)} cards")
    c.emit("chip_cards", cards=len(cards), seconds=time.perf_counter() - t0)
    print("\n".join(smi), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
