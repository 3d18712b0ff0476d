"""End-to-end LM training on the framework's full stack:
config -> sharded init -> deterministic data -> train step -> async
checkpoints -> resume.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e --device cpu   # ~1 min
    PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e --preset 100m --steps 300

The port of ``examples/train_lm_e2e.py``, with its presets, steps and
printed lines (``repro_torch.launch.train``'s).  The default ``tiny``
preset is qwen3-0.6b's smoke config, CPU-sized; ``--preset 100m`` trains
a ~100M parameter qwen3-geometry model (12 layers x 768), sized for the
card.  As in JAX's script, the preset replaces ``qwen3_0_6b.SMOKE`` so
that the launcher's ``--smoke`` path trains it (the port's
``get_smoke_config`` reads the attribute at call time).  ``--device``
(``cuda`` by default, or ``cpu``) is passed on to the launcher; the
checkpoints go to ``$TMPDIR/repro_lm_ckpt`` unless ``--ckpt-dir`` says
otherwise, and a second run resumes from the latest.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.launch import train

    if args.preset == "100m":
        # ~100M params: qwen3-geometry, 12 layers x 768
        import dataclasses

        from repro_torch.configs import qwen3_0_6b

        cfg = dataclasses.replace(
            qwen3_0_6b.CONFIG, n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=50304,
            loss_seq_chunks=1, grad_accum=1, remat=False,
        )
        smoke = qwen3_0_6b.SMOKE
        qwen3_0_6b.SMOKE = cfg  # reuse the --smoke path with our preset
        steps = args.steps or 300
        argv = ["--arch", "qwen3-0.6b", "--smoke", "--steps", str(steps),
                "--batch", "8", "--seq", "512", "--device", args.device,
                "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100"]
        print(f"training ~100M model for {steps} steps ...")
        try:
            return train.main(argv)
        finally:
            qwen3_0_6b.SMOKE = smoke

    steps = args.steps or 60
    return train.main([
        "--arch", "qwen3-0.6b", "--smoke", "--steps", str(steps),
        "--batch", "8", "--seq", "128", "--device", args.device,
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "25",
    ])


if __name__ == "__main__":
    raise SystemExit(main())
