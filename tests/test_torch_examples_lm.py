"""The LM examples of the port (``repro_torch.examples.{serve_lm,
train_lm_e2e}``), each run with ``--device cpu`` in a subprocess and held
to the port's own API: JAX's LM weights are salted per process (ROADMAP
§3), so the JAX scripts' tokens and losses are not reproducible.
``serve_lm``'s printed tokens equal ``Server.serve_queue`` on the same
weights (``init_params(cfg, 0)``); ``train_lm_e2e --preset tiny``'s
losses are finite and fall, and a second run resumes at the checkpointed
step."""

from __future__ import annotations

import ast
import math
import re

import numpy as np
import pytest
from test_torch_examples_common import finish, port_cmd, start


def test_serve_lm_prints_the_servers_tokens_on_the_same_weights():
    proc = start(port_cmd("serve_lm"), threads=2)
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server, ServerConfig
    from repro_torch.models import params as pmod

    want = []
    for arch in ("qwen3-0.6b", "recurrentgemma-2b"):
        cfg = get_smoke_config(arch)
        server = Server(cfg, pmod.init_params(cfg, 0, "cpu"), batch_slots=2,
                        scfg=ServerConfig(temperature=0.7))
        rng = np.random.default_rng(0)
        reqs = [rng.integers(2, cfg.vocab_size, size=n, dtype=np.int32) for n in (8, 12, 8, 10)]
        results = server.serve_queue(reqs, gen_len=8)
        want.append(f"[{arch}] served {len(results)} requests with 2 slots:")
        want += [f"  req {rid}: {results[rid][:8]}" for rid in sorted(results)]
    got = finish(proc).splitlines()
    assert got == want
    assert all(len(ast.literal_eval(x.split(": ", 1)[1])) == 8 for x in got if "req " in x)


def _losses(out: str) -> dict[int, float]:
    return {int(m[1]): float(m[2]) for m in re.finditer(r"step\s+(\d+) loss (\S+)", out)}


def test_train_lm_e2e_tiny_trains_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = finish(start(port_cmd("train_lm_e2e", "--steps", "6", "--ckpt-dir", ckpt),
                         threads=2))
    losses = _losses(first)
    assert sorted(losses) == [0, 5] and all(math.isfinite(v) for v in losses.values())
    assert losses[5] < losses[0]
    final, first_mean = (float(x) for x in re.search(
        r"final loss (\S+) \(first (\S+)\)", first).groups())
    assert final < first_mean
    second = finish(start(port_cmd("train_lm_e2e", "--steps", "8", "--ckpt-dir", ckpt),
                          threads=2))
    assert "resuming from step 6" in second
    assert sorted(_losses(second)) == [7]


@pytest.mark.parametrize("name", ["serve_lm", "train_lm_e2e"])
def test_example_raises_without_a_card_unless_given_the_cpu(name, monkeypatch):
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


def test_train_lm_e2e_100m_preset_leaves_the_smoke_config_as_it_was(monkeypatch, tmp_path):
    """The 100m preset replaces ``qwen3_0_6b.SMOKE`` for the launcher's
    ``--smoke`` path and puts it back after."""
    from repro_torch.configs import get_smoke_config, qwen3_0_6b
    from repro_torch.examples import train_lm_e2e
    from repro_torch.launch import train

    seen = {}

    def fake_main(argv):
        seen["cfg"], seen["argv"] = get_smoke_config("qwen3-0.6b"), argv
        return 0

    smoke = qwen3_0_6b.SMOKE
    monkeypatch.setattr(train, "main", fake_main)
    assert train_lm_e2e.main(["--preset", "100m", "--steps", "2", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path)]) == 0
    assert (seen["cfg"].n_layers, seen["cfg"].d_model, seen["cfg"].vocab_size) == (12, 768, 50304)
    assert 90e6 < seen["cfg"].n_params() < 130e6
    assert seen["argv"][seen["argv"].index("--device") + 1] == "cpu"
    assert qwen3_0_6b.SMOKE is smoke
