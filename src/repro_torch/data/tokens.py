"""Deterministic synthetic LM token pipeline.

The torch counterpart of ``repro.data.tokens``.  Every batch is a pure
function of (seed, step): resuming from a checkpoint at step k
regenerates exactly the batches k, k+1, ... with no state to restore.
Per-host sharding takes the host's slice of the global batch.

A batch is drawn on the host with JAX's threefry bits
(``repro_torch.core.prng``: ``fold_in``, ``split``, ``uniform``), then
moved to the device.  The tokens are Zipf-ish unigrams (``exp(u *
log V)`` truncated) with a copy of the token two positions back at
p = 0.35.  They equal ``repro.data.tokens``'s except where a float32
``exp(u * log V)`` lies within an ulp or two of an integer: XLA's float32
``exp`` and torch's differ there in the last bit, and the truncation
then moves the token by one (ROADMAP §3; about 5 in 100,000 tokens).

The "embeddings" and "ctx" draws (the musicgen and VLM stub frontends)
follow ``jax.random.normal``'s algorithm, ``sqrt(2) * erfinv(u)`` of a
uniform on (-1, 1), in float32 and then cast to bfloat16; JAX draws the
uniform in bfloat16 from other bits, so these are equal to JAX's in
shape, dtype and distribution, not value.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import prng


def _normal_bf16(key: np.ndarray, shape: tuple[int, ...]) -> torch.Tensor:
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.from_numpy(prng.uniform(key, shape, minval=lo, maxval=1.0))
    return (math.sqrt(2) * torch.erfinv(u)).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    d_model: int = 0  # for embedding-input archs (musicgen stub frontend)
    n_ctx_tokens: int = 0  # for VLM stub patch embeddings

    def host_batch(self, step: int) -> dict[str, torch.Tensor]:
        """The full global batch for `step`, on the CPU (pure function)."""
        key = prng.fold_in(prng.prng_key(self.seed), step)
        kz, kr, ke, kc = prng.split(key, 4)
        b, s = self.global_batch, self.seq_len
        # Zipf-ish marginal via exp of a uniform over log-vocab
        u = torch.from_numpy(prng.uniform(kz, (b, s)))
        log_v = torch.tensor(np.float32(np.log(self.vocab_size)))
        toks = torch.exp(u * log_v).to(torch.int32) - 1
        # short-range structure: with p=0.35 copy the token 2 positions back
        rep = torch.from_numpy(prng.uniform(kr, (b, s))) < 0.35
        toks = torch.where(rep, torch.roll(toks, 2, dims=1), toks)
        toks = torch.clamp(toks, 0, self.vocab_size - 1)
        out = {"tokens": toks}
        if self.d_model:
            out["embeddings"] = _normal_bf16(ke, (b, s, self.d_model))
        if self.n_ctx_tokens:
            out["ctx"] = _normal_bf16(kc, (b, self.n_ctx_tokens, self.d_model))
        return out

    def batch_at(self, step: int, device=None) -> dict[str, torch.Tensor]:
        """The full global batch for `step` on `device` (None: the card)."""
        from repro_torch.core.hdc_model import resolve_device

        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in self.host_batch(step).items()}

    def sharded_batch_at(self, step: int, mesh, rules=None) -> dict[str, torch.Tensor]:
        """The global batch for `step` laid out on `mesh` by
        ``rules.data_sharding`` (default ``ShardingRules()``): dim 0 over
        the batch axes, so that on a distributed mesh each rank holds its
        rows (every rank draws the same global batch and keeps its own)."""
        from repro_torch.distributed.sharding import ShardingRules

        rules = rules or ShardingRules()
        return {k: rules.data_sharding(mesh, v.ndim).place(v)
                for k, v in self.host_batch(step).items()}

    def host_batch_at(self, step: int, host_index: int, n_hosts: int, device=None) -> dict:
        """This host's slice of the global batch (per-host data loading)."""
        full = self.batch_at(step, device)
        per = self.global_batch // n_hosts
        return {k: v[host_index * per:(host_index + 1) * per] for k, v in full.items()}


def pipeline_for(cfg, shape, seed: int = 0) -> TokenPipeline:
    """TokenPipeline matching a (ModelConfig, ShapeConfig) cell."""
    return TokenPipeline(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        d_model=cfg.d_model if (cfg.input_mode == "embeddings" or cfg.n_ctx_tokens) else 0,
        n_ctx_tokens=cfg.n_ctx_tokens,
    )
