"""The port's LM server (repro_torch.launch.serve) against the JAX package's
``repro.launch.serve``, on the CPU, in float32 compute.

Both servers get the same fixed weights (the port's ``init_params`` of
seed 0, carried to JAX by ``convert.jax_params_from_lm``): JAX's own
init draws new weights in every process, and a token is an argmax, so a
draw with a near-tie within the libraries' float32 rounding would change
a test's outcome.

Greedy ``generate`` and ``serve_queue`` at temperature 0.7 (the request
mix of ``examples/serve_lm.py``, 2 slots) return the same tokens; the
sampling keys and Gumbel draws are bit-exact (``repro_torch.core.prng``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_smoke_config as jget_smoke
from repro.distributed import sharding as jsharding
from repro.launch import serve as jserve
from repro_torch import convert
from repro_torch.configs import get_smoke_config as tget_smoke
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import serve as tserve
from repro_torch.models import params as tparams_mod, transformer as tt

TOKEN_ARCHS = tuple(a for a in ARCHS if a not in ("musicgen-medium", "llama-3.2-vision-90b"))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    return convert.jax_params_from_lm(tparams_mod.init_params(tget_smoke(arch), 0, "cpu"))


def _servers(arch: str, temperature: float = 0.0, slots: int = 4):
    jc = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(tget_smoke(arch), compute_dtype="float32")
    tree = _params(arch)
    scfg = dict(temperature=temperature)
    js = jserve.Server(jc, jax.tree.map(jax.numpy.asarray, tree), slots, jserve.ServerConfig(**scfg))
    ts = tserve.Server(tc, convert.lm_params_from_jax(tc, tree, "cpu"), slots, tserve.ServerConfig(**scfg))
    return js, ts


@pytest.fixture
def no_mesh():
    jprev, tprev = jsharding.get_current_mesh(), tsharding.get_current_mesh()
    jsharding.set_current_mesh(None)
    tsharding.set_current_mesh(None)
    yield
    jsharding.set_current_mesh(jprev)
    tsharding.set_current_mesh(tprev)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_greedy_generate_equals_jax(arch, no_mesh):
    js, ts = _servers(arch)
    prompts = np.random.default_rng(0).integers(2, js.cfg.vocab_size, (4, 10), dtype=np.int32)
    want = js.generate(prompts, 8)
    got = ts.generate(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b"])
def test_serve_queue_at_temperature_equals_jax(arch, no_mesh):
    """examples/serve_lm.py's mix: 4 requests of 8-12 tokens over 2 slots,
    with refills (a re-prefill of the remaining and the new requests)."""
    js, ts = _servers(arch, temperature=0.7, slots=2)
    rng = np.random.default_rng(0)
    requests = [rng.integers(2, js.cfg.vocab_size, size=n, dtype=np.int32) for n in (8, 12, 8, 10)]
    want = js.serve_queue(requests, gen_len=8)
    got = ts.serve_queue(requests, gen_len=8)
    assert got == want and sorted(got) == [0, 1, 2, 3]
    # and a temperature sample through generate
    prompts = rng.integers(2, js.cfg.vocab_size, (2, 6), dtype=np.int32)
    np.testing.assert_array_equal(ts.generate(prompts, 6, seed=3), js.generate(prompts, 6, seed=3))


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-90b"])
def test_servers_refuse_the_context_and_embedding_archs_alike(arch, no_mesh):
    """A request carries tokens alone: musicgen needs embeddings and the
    VLM a context, so both servers fail at the prefill (JAX with a
    KeyError / AssertionError, the port with a KeyError / ValueError)."""
    js, ts = _servers(arch)
    prompts = np.random.default_rng(0).integers(2, js.cfg.vocab_size, (4, 6), dtype=np.int32)
    with pytest.raises((KeyError, AssertionError)):
        js.generate(prompts, 2)
    with pytest.raises((KeyError, ValueError)):
        ts.generate(prompts, 2)


def test_server_casts_the_weights_once_and_computes_as_the_masters():
    """The server holds the COMPUTE_CAST leaves in bf16 and every other leaf
    (norms, router, gates) in float32; its logits equal the model run on
    the float32 masters, which casts at every use."""
    cfg = tget_smoke("olmoe-1b-7b")
    params = tparams_mod.init_params(cfg, 0, "cpu")
    server = tserve.Server(cfg, params, 2, tserve.ServerConfig())
    moe = server.params["blocks"]["sub0"]["moe"]
    assert moe["w_up"].dtype == torch.bfloat16 and moe["router"].dtype == torch.float32
    assert server.params["embed"].dtype == torch.bfloat16
    assert server.params["final_norm"].dtype == torch.float32
    assert params["embed"].dtype == torch.float32  # the masters are untouched
    toks = torch.from_numpy(np.random.default_rng(1).integers(2, 512, (2, 7)).astype(np.int32))
    l1, s1 = tt.prefill(cfg, server.params, {"tokens": toks[:, :6]})
    l2, s2 = tt.prefill(cfg, params, {"tokens": toks[:, :6]})
    assert torch.equal(l1, l2)
    l1, _ = tt.decode_step(cfg, server.params, s1, toks[:, 6:])
    l2, _ = tt.decode_step(cfg, params, s2, toks[:, 6:])
    assert torch.equal(l1, l2)


def test_launcher_smoke_on_the_cpu(capsys):
    prev = tsharding.get_current_mesh()
    assert tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (4, 4) tokens" in out and "sample:" in out
    assert tsharding.get_current_mesh() is prev


def test_device_none_means_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget_smoke("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tparams_mod.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_jax(cfg, _params("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "qwen3-0.6b", "--smoke"])
