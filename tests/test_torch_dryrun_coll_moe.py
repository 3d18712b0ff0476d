"""The dry-run's collective term for the MoE archs (olmoe-1b-7b and
moonshot-v1-16b-a3b), whose experts the port lays out over ``model`` and
exchanges by all-to-all: the collective bytes of the port's sharded train
and decode steps on the (2, 2, 2) smoke mesh against XLA's partitioned
program of the same cell, every loop unrolled, compiled by JAX in a
subprocess with 8 host devices (``test_torch_dryrun.py``'s prelude and
``check_collectives``; ``COLL_RATIO`` states the band).  The JAX process
compiles while the port counts.

The MoE cells lie near the band's floor (0.50-0.54 of XLA's, jax 0.9.0):
XLA on the CPU carries the bf16 all-to-alls and all-reduces of these
steps in float32, so each of them counts twice the port's bytes.  The
decode steps send XLA's all-to-alls one for one (the dispatch buffer out
and back and the three expert weights' reshard, a layer); the train
steps send fewer, as DTensor carries some of the weight gradients' way
back in other kinds.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from test_torch_dryrun import _JAX_PRELUDE, SRC, check_collectives, meta_mesh, port_collectives

CELLS = [(arch, shape) for arch in ("olmoe-1b-7b", "moonshot-v1-16b-a3b")
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
    assert got is not None and got["coll_by_type"]["all-to-all"] > 0
    check_collectives(got, xla()[f"{arch} {shape_name}"], (arch, shape_name))


@pytest.mark.parametrize("arch,shape_name", [c for c in CELLS if c[1] == "decode_32k"])
def test_decode_all_to_all_counts_equal_xla(xla, arch, shape_name):
    """A decode step sends as many all-to-alls as XLA's program: per layer
    the dispatch buffer out and back, and the three expert weights'
    reshard from the rules' layout (``mlp`` on ``model``) to the experts
    on ``model``."""
    from repro_torch.configs import get_smoke_config

    got = port_collectives(get_smoke_config(arch), shape_name,
                           meta_mesh((2, 2, 2), ("pod", "data", "model")))
    assert got["coll_counts"]["all-to-all"] == xla()[f"{arch} {shape_name}"]["_counts"]["all-to-all"]
