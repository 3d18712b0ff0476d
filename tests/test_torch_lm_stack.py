"""The port's whole LM stack against the JAX package's, float32 compute,
every arch at its smoke config, on the CPU.

JAX's parameters are carried across (``convert.lm_params_from_jax``);
inputs come from numpy with a seed.  The full forward (``run_stack`` in
train mode), the prefill and 4 teacher-forced decode steps equal JAX to
rtol = atol = 1e-4 (xLSTM: atol 1e-3; its mLSTM divides by
max(|q.n|, e^-m) and its sLSTM by n, which amplify the two libraries'
float32 rounding to ~1.5e-4), and the port's decode equals its own full
forward at the same positions.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.configs import ARCHS
from repro.configs import get_smoke_config as jget_smoke
from repro_torch.configs import get_smoke_config as tget_smoke
from torch_lm_parity import batch_for, as_f32, jax_params, run_both


def _tol(arch):
    return dict(rtol=1e-4, atol=1e-3 if arch == "xlstm-1.3b" else 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_equal_jax_float32(arch):
    jc, tc = as_f32(jget_smoke(arch)), as_f32(tget_smoke(arch))
    batch = batch_for(jc, 2, 16, seed=1)
    jout, tout = run_both(jc, tc, jax_params(arch), batch, s=12, n_dec=4)
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert t.shape == j.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, **_tol(arch), err_msg=f"output {i}")
    # and the port's decode equals its own teacher-forced forward
    for i in range(5):
        np.testing.assert_allclose(tout[1 + i], tout[0][:, 11 + i], **_tol(arch))


