"""Batched LM serving with continuous batching over a request queue.

Demonstrates the serving layer: one prefill + one decode step (its cache
updated in place), temperature sampling, and slot refill when sequences
finish, across a dense arch and a recurrent one (state-based cache).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm              # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

The port of ``examples/serve_lm.py``, with its archs, sizes and printed
lines, but one difference: the JAX script draws its weights with
``jax.random`` (``init_params(cfg, PRNGKey(0))``), whose per-leaf keys
are salted with Python's per-process ``hash()``; the port draws each
leaf from a ``torch.Generator`` seeded from a crc32 of the seed and the
leaf's path (``init_params(cfg, 0, device)``), the same weights in every
process and on every device.  So its tokens are not JAX's; sampling
follows JAX's key schedule (``repro_torch.core.prng``).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import resolve_device
    from repro_torch.launch.serve import Server, ServerConfig
    from repro_torch.models import params as pmod

    dev = resolve_device(args.device)
    for arch in ("qwen3-0.6b", "recurrentgemma-2b"):
        cfg = get_smoke_config(arch)
        params = pmod.init_params(cfg, 0, dev)
        server = Server(cfg, params, batch_slots=2, scfg=ServerConfig(temperature=0.7))

        rng = np.random.default_rng(0)
        requests = [
            rng.integers(2, cfg.vocab_size, size=n, dtype=np.int32) for n in (8, 12, 8, 10)
        ]
        results = server.serve_queue(requests, gen_len=8)
        print(f"[{arch}] served {len(results)} requests with 2 slots:")
        for rid in sorted(results):
            print(f"  req {rid}: {results[rid][:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
