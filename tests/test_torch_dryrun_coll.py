"""The dry-run's collective term for the other three archs that the port
lays out over a mesh (qwen3-32b, gemma-7b, gemma3-12b; qwen3-0.6b's cells
are in ``test_torch_dryrun.py``): the collective bytes of the port's
sharded train and decode steps on the (2, 2, 2) smoke mesh against XLA's
partitioned program of the same cell, every loop unrolled, compiled by
JAX in a subprocess with 8 host devices (``test_torch_dryrun.py``'s
prelude and ``check_collectives``; ``COLL_RATIO`` states the band).  The
JAX process compiles while the port counts."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from test_torch_dryrun import _JAX_PRELUDE, SRC, check_collectives, meta_mesh, port_collectives

CELLS = [(arch, shape) for arch in ("qwen3-32b", "gemma-7b", "gemma3-12b")
         for shape in ("train_4k", "decode_32k")]
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
    assert got is not None
    check_collectives(got, xla()[f"{arch} {shape_name}"])
