"""Batched LM serving launcher: prefill + decode loop with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b   # full width, on the card
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu

The torch counterpart of ``repro.launch.serve``, with its semantics:
  * one prefill (prompt -> cache) and one decode step whose cache is
    updated in place;
  * greedy or temperature sampling, with JAX's key schedule
    (``repro_torch.core.prng``'s ``fold_in`` and ``categorical``);
  * slot-based continuous batching: finished sequences (EOS or length
    budget) are retired, and a refill re-prefills the batch of the
    remaining and new requests, left-padded with 0 (no padding mask);
  * recurrent archs (RG-LRU/xLSTM) serve through the same interface
    (their "cache" is O(1) state).

The server serves token-input archs with no context, as JAX's does:
musicgen-medium (``input_mode="embeddings"``) and llama-3.2-vision-90b
(``n_ctx_tokens``) fail at the prefill, since a request carries tokens
alone.  The model-level API (``repro_torch.models.transformer``) serves
every arch.

The float32 master weights are cast to the compute dtype once, when the
server is built (``transformer.cast_for_compute``), where the JAX
package casts them at every use.

Under ``python -m torch.distributed.run`` (one process a card; NCCL, or
gloo with ``--device cpu``) the launcher serves on ``mesh_for()`` of the
group's ranks, as JAX's serves on ``mesh_for()`` of every device: the
weights are drawn whole on every rank and laid out by the sharding rules
(``init_params(..., mesh=)``), and a ``Server`` on ``DTensor`` weights
lays each batch of tokens out over the batch axes, gathers the logits it
samples from (every rank samples the same token), and rank 0 prints.
Outside torchrun the mesh is of every visible card (or the CPU with
``--device cpu``): over several cards laying the weights out raises,
naming ``torch.distributed.run``, as ``launch.train`` does; nothing
serves on one card of several.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.core.hdc_model import resolve_device
from repro_torch.distributed.sharding import (
    ShardingRules,
    constrain_batch,
    get_current_mesh,
    is_dtensor,
    set_current_mesh,
)
from repro_torch.launch.mesh import describe, group_up, init_distributed, mesh_for
from repro_torch.models import params as pmod, transformer


@dataclasses.dataclass
class ServerConfig:
    max_len: int = 512
    temperature: float = 0.0
    eos_id: int = 1


class Server:
    """Static-shape batched decode server on the device of `params`, or on
    their mesh where they are ``DTensor``s (one process a card)."""

    def __init__(self, cfg, params, batch_slots: int, scfg: ServerConfig):
        self.cfg, self.scfg = cfg, scfg
        self.params = transformer.cast_for_compute(cfg, params)
        self.slots = batch_slots
        embed = params["embed"]
        self.mesh = embed.device_mesh if is_dtensor(embed) else None
        self.device = embed.to_local().device if self.mesh is not None else embed.device

    def _place(self, toks: torch.Tensor) -> torch.Tensor:
        """(B, n) tokens on the server's device, or laid out over the batch
        axes of its mesh."""
        toks = toks.to(self.device)
        if self.mesh is None:
            return toks
        from torch.distributed.tensor import Replicate, distribute_tensor

        return constrain_batch(distribute_tensor(toks, self.mesh, [Replicate()] * self.mesh.ndim,
                                                 src_data_rank=None))

    def _prefill(self, tokens: np.ndarray):
        batch = {"tokens": self._place(torch.as_tensor(tokens, dtype=torch.int32))}
        return transformer.prefill(self.cfg, self.params, batch)

    def _decode(self, state, toks: torch.Tensor):
        return transformer.decode_step(self.cfg, self.params, state, self._place(toks))

    def _sample(self, logits: torch.Tensor, key: np.ndarray) -> torch.Tensor:
        if is_dtensor(logits):  # every rank samples the same token from the whole logits
            logits = logits.full_tensor()
        if self.scfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return prng.categorical(key, logits / self.scfg.temperature).to(torch.int32)

    def generate(self, prompts: np.ndarray, gen_len: int, seed: int = 0) -> np.ndarray:
        """prompts: (B, P) int32.  Returns (B, gen_len) generated ids."""
        if prompts.shape[0] != self.slots:
            raise ValueError(f"{prompts.shape[0]} prompts for {self.slots} slots")
        logits, state = self._prefill(prompts)
        key = prng.prng_key(seed)
        toks = self._sample(logits, key)[:, None]
        out = [toks]
        for i in range(gen_len - 1):
            key = prng.fold_in(key, i)
            logits, state = self._decode(state, toks)
            toks = self._sample(logits, key)[:, None]
            out.append(toks)
        return torch.cat(out, dim=1).cpu().numpy()

    def serve_queue(self, requests: list[np.ndarray], gen_len: int) -> dict[int, list[int]]:
        """Continuous batching over a request queue (slot refill)."""
        results: dict[int, list[int]] = {}
        active: list[int | None] = [None] * self.slots
        queue = list(enumerate(requests))
        plen = max(len(r) for r in requests)

        def take(slot):
            if queue:
                rid, prompt = queue.pop(0)
                active[slot] = rid
                results[rid] = []
                padded = np.zeros(plen, np.int32)
                padded[-len(prompt):] = prompt
                return padded
            active[slot] = None
            return np.zeros(plen, np.int32)

        batch = np.stack([take(s) for s in range(self.slots)])
        logits, state = self._prefill(batch)
        toks = self._sample(logits, prng.prng_key(0))[:, None]
        steps = 0
        while any(a is not None for a in active) or queue:
            host_toks = toks.cpu().numpy()
            done_slots = []
            for s, rid in enumerate(active):
                if rid is None:
                    continue
                results[rid].append(int(host_toks[s, 0]))
                if len(results[rid]) >= gen_len or host_toks[s, 0] == self.scfg.eos_id:
                    done_slots.append(s)
            for s in done_slots:
                active[s] = None
            if not any(a is not None for a in active) and not queue:
                break
            if done_slots and queue:
                # refill: re-prefill the batch with remaining + new
                # requests (static shapes preserved)
                remaining = [
                    (active[s], np.asarray(results[active[s]], np.int32))
                    for s in range(self.slots)
                    if active[s] is not None
                ]
                for s in range(self.slots):
                    active[s] = None
                reqs = remaining + queue
                queue = []
                batch_rows = []
                for s in range(self.slots):
                    if reqs:
                        rid, toks_np = reqs.pop(0)
                        active[s] = rid
                        results.setdefault(rid, list(toks_np.tolist()))
                        padded = np.zeros(plen, np.int32)
                        padded[-min(len(toks_np), plen):] = toks_np[-plen:]
                        batch_rows.append(padded)
                    else:
                        batch_rows.append(np.zeros(plen, np.int32))
                queue = reqs
                logits, state = self._prefill(np.stack(batch_rows))
                toks = self._sample(logits, prng.prng_key(steps))[:, None]
            else:
                logits, state = self._decode(state, toks)
                toks = self._sample(logits, prng.fold_in(prng.prng_key(1), steps))[:, None]
            steps += 1
        return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--metrics-out", default=None,
                    help="write each rank's tokens, seconds, peak memory and leaf layouts "
                         "to <path>.rank<r>.json")
    args = ap.parse_args(argv)

    started = not group_up()
    group_dev = init_distributed(args.device)  # None outside torchrun
    dev = group_dev or resolve_device(args.device)
    rank0 = group_dev is None or torch.distributed.get_rank() == 0
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    previous = get_current_mesh()
    mesh = mesh_for(devices=[dev] if dev.type == "cpu" and group_dev is None else None)
    set_current_mesh(mesh)
    try:
        params = pmod.init_params(cfg, args.seed, mesh=mesh, rules=ShardingRules(fsdp=cfg.fsdp))
        server = Server(cfg, params, args.batch, ServerConfig(temperature=args.temperature))
        rng = np.random.default_rng(args.seed)
        prompts = rng.integers(2, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
        t0 = time.time()
        out = server.generate(prompts, args.gen)
        dt = time.time() - t0
    finally:
        set_current_mesh(previous)
    tps = args.batch * args.gen / dt
    if args.metrics_out:
        from repro_torch.launch.train import leaf_layouts, write_metrics

        write_metrics(args.metrics_out, dev, mesh, {
            "arch": cfg.name, "batch": args.batch, "prompt_len": args.prompt_len,
            "gen": args.gen, "tokens": out.tolist(), "seconds": dt, "tokens_per_s": tps,
            "leaves": leaf_layouts(server.params)})
    if rank0:
        where = describe(mesh) if mesh.distributed else str(dev)
        print(f"generated {out.shape} tokens in {dt:.2f}s ({tps:.1f} tok/s) on {where}")
        print("sample:", out[0][:16].tolist())
    if group_dev is not None and started:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
