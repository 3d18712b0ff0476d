"""The port's whole LM stack against the JAX package's in bf16 compute (the
configs' default), every arch at its smoke config, on the CPU.

The full forward, the prefill and 4 teacher-forced decode steps are held
to rtol = 5e-2 and atol = 1e-1 (atol 2e-1 for the RG-LRU arch, as in
``tests/test_models.py``).  ``test_models.py`` holds JAX to itself at
atol 5e-2; across the two libraries, which round bf16 differently (XLA
keeps excess precision inside its fusions), the atol needed at rtol 5e-2
was up to 0.062 (llama-3.2-vision, 5 layers) and 0.054 (gemma3, 6
layers) over four draws of JAX's weights, and 0.044 for the RG-LRU arch.
The weights are fixed (the port's ``init_params`` of seed 0, carried to
JAX by ``convert.jax_params_from_lm``), not JAX's own, which differ in
every process: at some draws the rounding turns into more than a
tolerance can hold, in JAX's own bf16 run as much as in the port's, and
a test must not pass or fail with the draw.

* MoE (moonshot, olmoe): a token whose router scores are near a tie picks
  another expert, and its logits move by ~1 (JAX's own bf16 logits differ
  from its float32 ones by up to 1.22 at such a token), and the later
  tokens that attend to it move too: over 16 draws of JAX's weights, one
  moved 20 of the 42 logit rows.  At the fixed weights no router is that
  near a tie (atol needed: 0.034 and 0.030).
* xLSTM: its normalisers (max(|q.n|, e^-m), the sLSTM's n) amplify bf16
  rounding everywhere; JAX's own bf16 logits differ from its float32
  ones by RMS 0.07-0.24 over five draws of JAX's weights.  So the port's
  bf16 logits must lie no further from JAX's float32 logits than twice
  JAX's bf16 logits do, in RMS (the ratio measured: 0.68-1.32 over those
  draws, 0.91 at the fixed weights).  The float32 stack is held tight in
  ``test_torch_lm_stack.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.configs import ARCHS
from repro.configs import get_smoke_config as jget_smoke
from repro_torch.configs import get_smoke_config as tget_smoke
from torch_lm_parity import as_f32, batch_for, fixed_params, run_both


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_equal_jax_bfloat16(arch):
    jc, tc = jget_smoke(arch), tget_smoke(arch)
    assert tc.compute_dtype == "bfloat16"
    batch = batch_for(jc, 2, 16, seed=1)
    jout, tout = run_both(jc, tc, fixed_params(arch), batch, s=12, n_dec=4)
    for j, t in zip(jout, tout):
        assert t.shape == j.shape and np.isfinite(t).all()
    if arch == "xlstm-1.3b":
        jout32, _ = run_both(as_f32(jc), as_f32(tc), fixed_params(arch), batch, s=12, n_dec=4)
        flat = lambda xs: np.concatenate([x.ravel() for x in xs])  # noqa: E731
        j16, t16, j32 = flat(jout), flat(tout), flat(jout32)
        assert _rms(t16 - j32) <= 2 * _rms(j16 - j32), (_rms(t16 - j32), _rms(j16 - j32))
        return
    atol = 2e-1 if arch == "recurrentgemma-2b" else 1e-1
    for i, (j, t) in enumerate(zip(jout, tout)):
        np.testing.assert_allclose(t, j, rtol=5e-2, atol=atol, err_msg=f"output {i}")
