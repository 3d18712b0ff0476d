"""The dry-run's collective term for the archs of recurrent and
cross-attention blocks and of embedding input (recurrentgemma-2b,
llama-3.2-vision-90b, musicgen-medium, xlstm-1.3b), whose mixers the port
runs on each rank's shards (``models.per_shard``, ``attention._per_shard``):
the collective bytes of the port's sharded step on the (2, 2, 2) smoke
mesh against XLA's partitioned program of the same cell, every loop
unrolled, compiled by JAX in a subprocess with 8 host devices
(``test_torch_dryrun.py``'s prelude and ``check_collectives``;
``COLL_RATIO`` states the band).  Their train cells, and xlstm-1.3b's
decode cell: the smoke config's mLSTM chunks of 4 over a 4,096-token train
sequence would unroll to 1,024 chunks a layer in XLA's program, and the
decode step is one token.  ``test_torch_dryrun.py`` holds these archs'
decode, long and prefill cells.  The JAX process compiles while the port
counts.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from test_torch_dryrun import _JAX_PRELUDE, SRC, check_collectives, meta_mesh, port_collectives

CELLS = [(arch, "train_4k") for arch in ("recurrentgemma-2b", "llama-3.2-vision-90b",
                                         "musicgen-medium")] + [("xlstm-1.3b", "decode_32k")]
_JAX_COLL = f"""
for arch, name in {CELLS!r}:
    cfg = dataclasses.replace(get_smoke_config(arch), scan_layers=False, unroll_loops=True,
                              grad_accum=1)
    out[arch + " " + name] = roofline.collective_bytes(compiled(cfg, name).as_text())
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def xla():
    """A function that returns XLA's collective bytes of the cells; the
    JAX process starts with the module and is read on the first call."""
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_PRELUDE + _JAX_COLL], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    done: dict = {}

    def read() -> dict:
        if not done:
            stdout, stderr = proc.communicate(timeout=600)
            line = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
            assert line, stderr[-3000:]
            done.update(json.loads(line[0][len("RESULT "):]))
        return done

    yield read
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_collective_bytes_hold_to_xla(xla, arch, shape_name):
    from repro_torch.configs import get_smoke_config

    got = port_collectives(get_smoke_config(arch), shape_name,
                           meta_mesh((2, 2, 2), ("pod", "data", "model")))
    assert got["coll_bytes"] > 0
    check_collectives(got, xla()[f"{arch} {shape_name}"], (arch, shape_name))
