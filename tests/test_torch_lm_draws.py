"""The port's float32 LM stack on JAX's own weight draws, on the CPU.

JAX's ``init_params`` salts each leaf's key with Python's ``hash()``, so
each ``PYTHONHASHSEED`` draws other weights.  Each named hash seed's draw is
made in a subprocess (``torch_lm_parity.draw_jax_params``) and run through
the cases of ``test_torch_lm_stack.py``: the full forward, the prefill and
4 teacher-forced decode steps.

xlstm-1.3b is ill-conditioned at smoke width on some draws: over the 64
draws of ``tools/lm_draw_sweep.py`` its largest distance from JAX ran from
2.4e-5 to 1.8e-3, so a fixed tolerance that holds one draw misses another
(atol 1e-3 missed at hash seeds 26 and 61).  It is held to the draw's own
conditioning instead: every output's largest distance from JAX is at most
JAX's largest move when every weight is scaled by (1 + 1e-6 eps), eps from
numpy's seed 0 (``torch_lm_parity.moved``; factor 1).  The sweep's largest
ratio of the two is 0.63, and an error of 1e-5 of the mLSTM blocks'
output, which atol 1e-3 on the fixed weights lets pass, breaks the bound
at seed 26.  The other archs are steady over the sweep (ratio at most
0.30, distance at most 6.6e-6) and keep the fixed tolerance of
``test_torch_lm_stack.py`` (rtol = atol = 1e-4).

The seeds are 26, whose draw failed atol 1e-3 (1.79e-3 under torch's and
XLA's default threads against a 1e-6 move of 9.6e-3), and the sweep's four
worst by xLSTM's ratio.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.configs import ARCHS
from repro.configs import get_smoke_config as jget_smoke
from repro_torch.configs import get_smoke_config as tget_smoke
from torch_lm_parity import (as_f32, batch_for, check_within_witness, draw_jax_params, jax_run,
                             port_run, witness_moves)

#: hash seeds whose JAX draws are held: 26, then the sweep's four worst
#: by xLSTM's ratio (one thread or torch's and XLA's default threads)
HASH_SEEDS = (26, 61, 27, 2, 15)
#: archs held to JAX's own 1e-6 move rather than a fixed tolerance
WITNESSED = ("xlstm-1.3b",)


@pytest.fixture(scope="module")
def draws(request, tmp_path_factory) -> dict[int, dict]:
    """JAX's smoke weights of every arch under each hash seed of the
    selected cases, drawn in subprocesses side by side."""
    seeds = sorted({it.callspec.params["hashseed"] for it in request.session.items
                    if it.module is request.module and hasattr(it, "callspec")})
    paths = [tmp_path_factory.mktemp(f"hash{s}") / "draw.npz" for s in seeds]
    with ThreadPoolExecutor(len(seeds)) as pool:
        return dict(zip(seeds, pool.map(lambda s, path: draw_jax_params(ARCHS, s, path), seeds, paths)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("hashseed", HASH_SEEDS)
def test_forward_prefill_decode_on_jax_draw(draws, hashseed, arch):
    jc, tc = as_f32(jget_smoke(arch)), as_f32(tget_smoke(arch))
    batch = batch_for(jc, 2, 16, seed=1)
    tree = draws[hashseed][arch]
    tout = port_run(tc, tree, batch, s=12, n_dec=4)
    if arch in WITNESSED:
        jout, moves = witness_moves(jc, tree, batch, s=12, n_dec=4)
        check_within_witness(jout, tout, moves)
    else:
        (jout,) = jax_run(jc, [tree], batch, s=12, n_dec=4)
        for i, (j, t) in enumerate(zip(jout, tout)):
            assert t.shape == j.shape and np.isfinite(t).all()
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4, err_msg=f"output {i}")
    # the port's decode equals its own teacher-forced forward (the stack test's bound)
    for i in range(5):
        np.testing.assert_allclose(tout[1 + i], tout[0][:, 11 + i], rtol=1e-4,
                                   atol=1e-3 if arch in WITNESSED else 1e-4)
