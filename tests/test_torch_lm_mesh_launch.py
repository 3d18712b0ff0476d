"""The LM launchers under ``python -m torch.distributed.run`` on 4 gloo
processes (``--device cpu``), at qwen3-0.6b's smoke config (bfloat16
compute), against the same launchers in one process:

* ``launch.train --model-parallel 2`` (a (2, 2) mesh): rank 0 alone prints;
  every rank's leaves are ``DTensor``s laid out by
  ``ShardingRules(fsdp=cfg.fsdp)``, as JAX's launcher lays them out; every
  rank sees the same losses, and they lie within LOSS_BAND of the
  one-process run's;
* a SIGTERM to the job (torchrun forwards it to every rank) while it
  trains: every rank stops at the same step, the checkpoint holds the step
  after the last one logged, and a second run resumes there, its losses
  those of an uninterrupted run;
* ``launch.serve`` (``mesh_for()``: a (1, 4) mesh, the heads over 4
  ranks): the tokens of the one-process run, where a row may part from them
  only at a step whose top-2 logit margin in the one-process run is below
  BF16_NEAR_TIE (a bfloat16 near-tie: the margins there are multiples of
  bf16's spacing, 1/64 at these logits; measured, one row parts at a margin
  of 1/64).
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

import torch_lm_mesh_common as common

#: the bf16 band of the sharded launcher's losses against one process's
#: (qwen3-0.6b smoke, batch 4 x 32, 12 steps; measured on the CPU: at most
#: 2.1e-3 apart, from the order in which the shards' bf16 products are summed)
LOSS_BAND = 1e-2
BF16_NEAR_TIE = 0.05
STEPS = 12
TRAIN = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
         "--log-every", "1", "--steps", str(STEPS)]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=common.SRC, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _launch(module: str, args: list[str], procs: int = common.WORLD, **kw) -> subprocess.Popen:
    """The launcher in a subprocess, under torchrun with `procs` ranks (0:
    one process), at nice 10 as ``common.start_ranks`` starts its ranks."""
    pre = ["nice", "-n", "10", sys.executable]
    if procs:
        pre += ["-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={procs}"]
    return subprocess.Popen(pre + ["-m", module, *args], env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, **kw)


def _losses(out: str) -> dict[int, float]:
    pat = re.compile(r"^step\s+(\d+) loss (\S+) ")
    return {int(m[1]): float(m[2]) for m in map(pat.match, out.splitlines()) if m}


def _done(proc: subprocess.Popen, timeout: int = 300) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The sharded and the one-process run to the end, side by side."""
    d = tmp_path_factory.mktemp("launch")
    sharded = _launch("repro_torch.launch.train",
                      TRAIN + ["--model-parallel", "2", "--metrics-out", str(d / "train")])
    one = _launch("repro_torch.launch.train", TRAIN, procs=0)
    return d, _done(sharded), _done(one)


def test_sharded_train_launcher_lays_out_its_state_and_follows_one_process(trained):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding
    from repro_torch.models import params as pmod

    d, out, one = trained
    assert len(re.findall(r"^training ", out, re.M)) == 1  # rank 0 alone prints
    assert "(4 processes)" in out and "{'data': 2, 'model': 2}" in out
    losses, ref = _losses(out), _losses(one)
    assert sorted(losses) == sorted(ref) == list(range(STEPS))
    assert max(abs(losses[k] - ref[k]) for k in ref) <= LOSS_BAND
    cfg = get_smoke_config("qwen3-0.6b")
    mesh = sharding.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("data", "model"))
    rules = sharding.ShardingRules(fsdp=cfg.fsdp)
    want = {k: [str(p) for p in rules.param_sharding(s.shape, s.axes, mesh).placements]
            for k, s in common.flat(pmod.param_specs(cfg))}
    for rank in range(common.WORLD):
        rec = json.loads((d / f"train.rank{rank}.json").read_text())
        assert rec["rank"] == rank and rec["world"] == common.WORLD
        assert [round(x, 4) for x in rec["losses"]] == [losses[k] for k in range(STEPS)]
        assert len(rec["step_ms"]) == STEPS - 1
        for key, leaf in rec["leaves"].items():
            assert leaf["type"] == "DTensor", key
            group, name = key.split("/", 1)
            name = name.split("/", 1)[1] if group == "opt" else name
            assert leaf["placements"] == want[name], key


def test_sigterm_to_every_rank_saves_the_last_step_and_the_run_resumes_there(trained, tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    _, straight, _ = trained
    ckpt = ["--model-parallel", "2", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)]
    first = _launch("repro_torch.launch.train", TRAIN + ckpt)
    lines = []
    try:
        for line in first.stdout:
            lines.append(line)
            logged = _losses(line)
            if logged and max(logged) >= 5:
                first.send_signal(signal.SIGTERM)  # torchrun forwards it to every rank
                break
        out, err = first.communicate(timeout=120)
    finally:
        if first.poll() is None:
            first.kill()
            first.wait()
    assert "ChildFailedError" not in err and "exitcode" not in err, err[-3000:]
    logged = _losses("".join(lines) + out)
    saved = CheckpointManager(tmp_path).latest_step()
    assert max(logged) < STEPS - 1 and saved == max(logged) + 1
    resumed = _done(_launch("repro_torch.launch.train", TRAIN + ckpt))
    assert f"resuming from step {saved}" in resumed
    got, want = _losses(resumed), _losses(straight)
    assert sorted(got) == list(range(saved, STEPS))
    assert all(abs(got[k] - want[k]) <= 1e-4 for k in got), (got, want)


def test_sharded_serve_launcher_gives_the_one_process_tokens(tmp_path):
    args = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu"]
    sharded = _launch("repro_torch.launch.serve", args + ["--metrics-out", str(tmp_path / "s")])
    one = _launch("repro_torch.launch.serve", args + ["--metrics-out", str(tmp_path / "o")],
                  procs=0)
    out, ref = _done(sharded), _done(one)
    assert out.count("generated (4, 16) tokens") == 1 and "(4 processes)" in out
    want = json.loads((tmp_path / "o.rank0.json").read_text())["tokens"]
    tokens, margins = _one_process_greedy()
    assert tokens.tolist() == want
    for rank in range(common.WORLD):
        rec = json.loads((tmp_path / f"s.rank{rank}.json").read_text())
        assert rec["mesh"] == {"data": 1, "model": 4}
        assert all(leaf["type"] == "DTensor" for leaf in rec["leaves"].values())
        got = np.asarray(rec["tokens"])
        assert got.shape == tokens.shape
        for row in range(len(got)):
            diff = np.flatnonzero(got[row] != tokens[row])
            if len(diff):
                assert margins[row, diff[0]] < BF16_NEAR_TIE, (row, diff[0], margins[row])


def _one_process_greedy() -> tuple[np.ndarray, np.ndarray]:
    """The serve launcher's greedy tokens in this process, and each step's
    top-2 logit margin."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server, ServerConfig
    from repro_torch.models import params as pmod

    cfg = get_smoke_config("qwen3-0.6b")
    server = Server(cfg, pmod.init_params(cfg, 0, "cpu"), 4, ServerConfig())
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (4, 32), dtype=np.int32)
    logits, state = server._prefill(prompts)
    toks, margins = [], []
    for i in range(16):
        if i:
            logits, state = server._decode(state, toks[-1][:, None])
        top = torch.sort(logits.float(), -1).values
        margins.append((top[:, -1] - top[:, -2]).numpy())
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    return torch.stack(toks, 1).numpy(), np.stack(margins, 1)


@pytest.mark.parametrize("module", ["serve", "train"])
def test_launcher_on_two_cards_without_torchrun_raises(module, monkeypatch):
    """One process that sees two cards and no process group lays the model
    out over neither: building the mesh of both cards' shardings raises,
    naming ``torch.distributed.run``, before a tensor reaches a card (the
    two cards are what ``torch.cuda`` reports here)."""
    import importlib

    import torch

    from repro_torch.distributed.sharding import get_current_mesh

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    launcher = importlib.import_module(f"repro_torch.launch.{module}")
    with pytest.raises(NotImplementedError, match="torch.distributed.run"):
        launcher.main(["--arch", "qwen3-0.6b", "--smoke"])
    assert get_current_mesh() is None
