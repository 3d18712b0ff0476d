"""``python -m repro_torch.launch.train`` on the CPU: JAX's flags plus
``--device``, the loop, log lines, checkpoint cadence, resume and the
SIGTERM contract; and the training path's twins on a card (``cuda``
marker; this file imports no JAX, so it runs on the card's machine).

* ``--arch qwen3-0.6b --smoke --device cpu --steps 6`` runs at the JAX
  launcher's defaults (batch 8, seq 256, lr 3e-4, warmup 20) and its
  loss falls (the ``final loss`` line: mean of the last 5 below the
  first 5);
* every arch's smoke config trains two steps with finite loss and
  ``grad_norm`` (batch 2, seq 32);
* without ``--device``, on a machine with no card, it raises;
* SIGTERM in the middle of a run leaves a checkpoint at the last
  completed step and exits 0, and the resumed run ends with parameters
  and optimizer state equal, bit for bit, to an uninterrupted run's.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import train

SRC = str(Path(__file__).resolve().parents[1] / "src")
STEP_LINE = re.compile(r"^step\s+(\d+) loss (\S+) gnorm (\S+) lr (\S+)")


def _steps(out: str) -> dict[int, tuple[float, float]]:
    return {int(m[1]): (float(m[2]), float(m[3]))
            for m in (STEP_LINE.match(line) for line in out.splitlines()) if m}


def test_launcher_defaults_train_and_the_loss_falls(capsys, tmp_path):
    prev, handler = tsharding.get_current_mesh(), signal.getsignal(signal.SIGTERM)
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps", "6",
            "--ckpt-dir", str(tmp_path)]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "training qwen3-0.6b on mesh{'data': 1, 'model': 1} on 1 devices; 106,880 params" in out
    assert sorted(_steps(out)) == [0, 5]
    final, first = map(float, re.search(r"final loss (\S+) \(first (\S+)\)", out).groups())
    assert final < first
    assert train.CheckpointManager(tmp_path).all_steps() == [6]  # the final save
    assert tsharding.get_current_mesh() is prev
    assert signal.getsignal(signal.SIGTERM) is handler  # the launcher's hook is taken down


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_every_smoke_arch(arch, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "32", "--log-every", "1"]
    assert train.main(argv) == 0
    steps = _steps(capsys.readouterr().out)
    assert sorted(steps) == [0, 1]
    assert all(np.isfinite(loss) and np.isfinite(gn) and gn > 0 for loss, gn in steps.values())


def test_launcher_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(512, 8, 2).batch_at(0)


def test_production_mesh_needs_its_devices():
    with pytest.raises(ValueError, match="256 devices"):
        train.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--production"])


def _launch(args: list[str], device: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b", "--smoke",
           "--device", device, "--log-every", "1", "--ckpt-every", "10", *args]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _final_state(ckpt: Path, step: int) -> list[np.ndarray]:
    mgr = CheckpointManager(ckpt)
    meta = mgr.leaf_meta(step)
    return [np.load(ckpt / f"step_{step:09d}" / m["file"]) for m in meta.values()]


def preempt_and_resume(tmp_path: Path, device: str, steps: int, extra: tuple = ()) -> dict:
    """Run to `steps` three ways: SIGTERM'd after it logs step 15 then
    resumed, and uninterrupted.  Returns what the checks need."""
    run = ["--steps", str(steps), *extra, "--ckpt-dir"]
    straight = _launch([*run, str(tmp_path / "straight")], device)
    first = _launch([*run, str(tmp_path / "preempted")], device)
    lines = []
    for line in first.stdout:
        lines.append(line)
        m = STEP_LINE.match(line)
        if m and int(m[1]) >= 15:
            first.send_signal(signal.SIGTERM)
            break
    out, err = first.communicate(timeout=300)
    lines.append(out)
    logged = _steps("".join(lines))
    saved = CheckpointManager(tmp_path / "preempted").latest_step()
    second = _launch([*run, str(tmp_path / "preempted")], device)
    out2, err2 = second.communicate(timeout=300)
    out3, err3 = straight.communicate(timeout=300)
    for p, e in ((second, err2), (straight, err3)):
        assert p.returncode == 0, e[-3000:]
    return {"rc": first.returncode, "stderr": err, "logged": logged, "saved": saved,
            "resumed": out2, "straight": out3}


def test_sigterm_saves_the_last_completed_step_and_resume_is_bit_identical(tmp_path):
    steps = 100
    r = preempt_and_resume(tmp_path, "cpu", steps, ("--batch", "4", "--seq", "128"))
    assert r["rc"] == 0, r["stderr"][-3000:]
    last = max(r["logged"])
    assert last < steps - 1, "the run ended before the signal"
    assert r["saved"] == last + 1  # every completed step was logged, and no more
    assert f"resuming from step {last + 1}" in r["resumed"]
    resumed, straight = _steps(r["resumed"]), _steps(r["straight"])
    assert min(resumed) == last + 1 and max(resumed) == steps - 1
    for step, (loss, gn) in resumed.items():
        assert (loss, gn) == straight[step], step
    a = _final_state(tmp_path / "preempted", steps)
    b = _final_state(tmp_path / "straight", steps)
    assert len(a) == len(b) > 0 and all(np.array_equal(x, y) for x, y in zip(a, b))
    manifest = json.loads((tmp_path / "preempted" / f"step_{steps:09d}" / "manifest.json").read_text())
    assert {m["key"].split("/")[0] for m in manifest["leaves"]} == {"params", "opt"}


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the launcher's default device)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_sigterm_resume_on_the_card(cuda, tmp_path):
    """On the card the embedding's backward accumulates with atomics, so
    the resumed run's losses are held within 1e-3 of the uninterrupted
    run's, not bit for bit."""
    steps = 40
    r = preempt_and_resume(tmp_path, "cuda", steps)
    assert r["rc"] == 0, r["stderr"][-3000:]
    last = max(r["logged"])
    assert last < steps - 1 and r["saved"] == last + 1
    resumed, straight = _steps(r["resumed"]), _steps(r["straight"])
    assert min(resumed) == last + 1
    for step, (loss, _) in resumed.items():
        assert abs(loss - straight[step][0]) <= 1e-3, step


@pytest.mark.cuda
def test_cuda_launcher_defaults_train(cuda, capsys):
    assert train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "6"]) == 0
    out = capsys.readouterr().out
    final, first = map(float, re.search(r"final loss (\S+) \(first (\S+)\)", out).groups())
    assert final < first


def _step_on(arch: str, dev):
    import dataclasses

    from repro_torch.data.tokens import pipeline_for
    from repro_torch.models import params as pmod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.training.step import make_train_step
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = tree_map(lambda t: t.to(dev), pmod.init_params(cfg, 0, "cpu"))
    batch = pipeline_for(cfg, ShapeConfig("t", 16, 2, "train")).batch_at(0, dev)
    step = make_train_step(cfg, OptimizerConfig(warmup_steps=0, total_steps=10, schedule="constant"))
    params, _, metrics = step(params, init_opt_state(params), batch, 0)
    return tree_map(lambda t: t.cpu(), params), {k: v.item() for k, v in metrics.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_train_step_equals_the_cpu_step(cuda, arch):
    """float32 compute, TF32 off: loss within 1e-5 (xLSTM 1e-4), grad_norm
    within 1e-4 relative, params after within atol 2e-3 / rtol 1e-3."""
    from repro_torch.tree import tree_leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    (pc, mc), (pp, mp) = _step_on(arch, cuda), _step_on(arch, torch.device("cpu"))
    assert abs(mc["loss"] - mp["loss"]) <= (1e-4 if arch == "xlstm-1.3b" else 1e-5)
    assert np.isfinite(mc["grad_norm"]) and abs(mc["grad_norm"] - mp["grad_norm"]) <= 1e-4 * mp["grad_norm"]
    for a, b in zip(tree_leaves(pc), tree_leaves(pp)):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=1e-3)


@pytest.mark.cuda
def test_cuda_async_save_copies_the_tensors_before_it_returns(cuda, tmp_path):
    tree = {"w": torch.randn(1024, 1024, device=cuda), "b": torch.randn(7, device=cuda).to(torch.bfloat16)}
    want = {k: v.cpu() for k, v in tree.items()}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree, blocking=False)
    for v in tree.values():
        v.add_(1)  # the next step, in place
    mgr.wait()
    got = mgr.restore(1, tree)
    assert torch.equal(torch.as_tensor(got["w"]), want["w"]) and torch.equal(got["b"], want["b"])
