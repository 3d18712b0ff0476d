"""Where does the port's xLSTM part from JAX's, on one JAX weight draw?

Draws JAX's xlstm-1.3b smoke weights as ``init_params`` does under a given
``PYTHONHASHSEED`` (``torch_lm_parity.draw_jax_params``), takes the
float32 train-mode forward of ``tests/test_torch_lm_stack.py`` (batch 2 x
16 tokens, numpy seed 1) and runs it one block at a time.  For each of the
8 residual blocks (7 mLSTM in their chunkwise form, chunk 4, then 1 sLSTM)
and for the final norm with the tied unembedding it prints:

* ``local``: the port's output against JAX's on JAX's own input to that
  block, beside JAX's move when the block's weights are scaled by
  (1 + 1e-6 eps) (the ``torch_lm_parity.moved`` draw of the whole model,
  so the same eps as the whole-model witness), and their ratio;
* ``mixer``: the same for the block's mixer alone (``mlstm_chunkwise`` or
  ``slstm_block``) on JAX's normed input;
* ``chain``: the port's hidden state, carried through the port's own
  blocks, against JAX's, beside JAX's chained move under the same
  weight change.

A block whose local ratio is above 1 parts from JAX by more than its own
float32 conditioning: a fault of the port.

    python tools/xlstm_localise.py --hashseed 26 [--threads 1]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hashseed", type=int, default=26)
    ap.add_argument("--threads", type=int, default=0, help="torch threads; 0 keeps the default")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    from repro.configs import get_smoke_config as jget
    from repro.models import layers as jlayers, transformer as jt, xlstm as jx
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config as tget
    from repro_torch.models import layers as tlayers, transformer as tt, xlstm as tx
    from torch_lm_parity import as_f32, batch_for, draw_jax_params, moved

    arch = "xlstm-1.3b"
    jc, tc = as_f32(jget(arch)), as_f32(tget(arch))
    with tempfile.TemporaryDirectory() as tmp:
        tree = draw_jax_params([arch], args.hashseed, Path(tmp) / "draw.npz")[arch]
    near = moved(tree)
    batch = batch_for(jc, 2, 16, seed=1)
    n = batch["tokens"].shape[1]
    pos = jnp.arange(n)[None]

    def jblock(p, i):
        return jax.tree.map(lambda a: jnp.asarray(a[0]), p["blocks"][f"sub{i}"])

    tparams = convert.lm_params_from_jax(tc, tree, "cpu")

    def tblock(i):
        return jax.tree.map(lambda a: a[0], tparams["blocks"][f"sub{i}"])

    def gap(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    def row(name, dist, move):
        print(f"{name:<22} {dist:10.3e} {move:10.3e} {dist / move:8.3f}")

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x_j = jt.embed_inputs(jc, jax.tree.map(jnp.asarray, tree), jb, pos)
    x_m = jt.embed_inputs(jc, jax.tree.map(jnp.asarray, near), jb, pos)
    x_t = torch.from_numpy(np.array(x_j))
    print(f"{arch} hash seed {args.hashseed}, torch threads {torch.get_num_threads()}")
    print(f"{'block':<22} {'distance':>10} {'1e-6 move':>10} {'ratio':>8}")
    for i, kind in enumerate(jc.layer_pattern):
        apply = jax.jit(lambda p, x, kind=kind: jt.apply_block(jc, kind, p, x, mode="train", positions=pos)[0])
        pj, pm, pt = jblock(tree, i), jblock(near, i), tblock(i)
        yj, ym = apply(pj, x_j), apply(pm, x_j)
        yt = tt.apply_block(tc, kind, pt, torch.from_numpy(np.array(x_j)), mode="train",
                            positions=torch.from_numpy(np.array(pos)))[0]
        row(f"local {i} {kind}", gap(yt.numpy(), yj), gap(ym, yj))
        h = jlayers.rms_norm(x_j, pj["pre_norm"])
        if kind == "mlstm":
            mix = jax.jit(lambda p, h: jx.mlstm_chunkwise(jc, p, h, None, return_state=False)[0])
            tmix = tx.mlstm_chunkwise(tc, pt["mixer"], torch.from_numpy(np.array(h)), None,
                                      return_state=False)[0]
        else:
            mix = jax.jit(lambda p, h: jx.slstm_block(jc, p, h, None, mode="train")[0])
            tmix = tx.slstm_block(tc, pt["mixer"], torch.from_numpy(np.array(h)), None, mode="train")[0]
        mj = mix(pj["mixer"], h)
        row(f"mixer {i} {kind}", gap(tmix.numpy(), mj), gap(mix(pm["mixer"], h), mj))
        x_t = tt.apply_block(tc, kind, pt, x_t, mode="train", positions=torch.from_numpy(np.array(pos)))[0]
        x_m = apply(pm, x_m)
        x_j = yj
        row(f"chain {i} {kind}", gap(x_t.numpy(), x_j), gap(x_m, x_j))
    head = jax.jit(lambda p, x: jt.unembed(jc, p, jlayers.rms_norm(x, p["final_norm"])))
    jp, jm = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, near)
    lj = head(jp, x_j)
    lt = tt.unembed(tc, tparams, tlayers.rms_norm(torch.from_numpy(np.array(x_j)), tparams["final_norm"]))
    row("local norm+unembed", gap(lt.numpy(), lj), gap(head(jm, x_j), lj))
    lt = tt.unembed(tc, tparams, tlayers.rms_norm(x_t, tparams["final_norm"]))
    row("chain logits", gap(lt.numpy(), lj), gap(head(jm, x_m), lj))
    full = tt.forward_logits(tc, tparams, {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    row("port forward_logits", gap(full, lj), gap(head(jm, x_m), lj))


if __name__ == "__main__":
    main()
