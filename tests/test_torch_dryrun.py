"""The port's dry-run (``repro_torch.launch.{specs, dryrun}``,
``repro_torch.analysis.roofline``) against the JAX package's, on nine
smoke cells over a (2, 2, 2) ``pod x data x model`` mesh, with JAX
compiling the same cells in subprocesses with 8 host devices.

* The per-device argument bytes equal XLA's
  ``memory_analysis().argument_size_in_bytes``.  One difference is
  named: ``jax.jit`` prunes the arguments a step does not read
  (``keep_unused=False``), and XLA counts only those it keeps, where the
  specs count every input.
* The counted flops and bytes hold to XLA's ``cost_analysis()`` of the
  same cell compiled with every loop unrolled (``scan_layers=False,
  unroll_loops=True, grad_accum=1``: XLA counts a ``while`` body once,
  and the unrolled attention skips the causally dead blocks as the
  port's does).  The prefill cells run their attention in 8,192-wide
  blocks on both sides, so that XLA compiles 10 block pairs a layer and
  not 1,056; the smoke configs are those of the other cells.
* ``cells()`` equals JAX's list.
* The collective bytes that the port's sharded step sends
  (``dryrun.count_collectives``: the step on ``DTensor``s over the mesh,
  ``fake`` backend) hold to ``roofline.collective_bytes`` of XLA's
  partitioned program of the same cell, every loop unrolled, for every
  arch: non-zero for every kind XLA's is, and the total within COLL_RATIO
  of XLA's.  ``test_torch_dryrun_coll.py`` and
  ``test_torch_dryrun_coll_moe.py`` do the same for more cells.

The flop counts on meta against CPU tensors and ``run_hdc`` are in
``test_torch_dryrun_hdc.py``, ``main`` and the roofline terms in
``test_torch_dryrun_main.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

#: (arch, shape) cells of the smoke configs compared with XLA
CELLS = [
    ("qwen3-0.6b", "train_4k"),
    ("qwen3-0.6b", "prefill_32k"),
    ("qwen3-0.6b", "decode_32k"),
    ("olmoe-1b-7b", "train_4k"),
    ("olmoe-1b-7b", "decode_32k"),
    ("recurrentgemma-2b", "decode_32k"),
    ("xlstm-1.3b", "long_500k"),
    ("llama-3.2-vision-90b", "prefill_32k"),
    ("musicgen-medium", "decode_32k"),
]
#: inputs a cell's step does not read, which jax.jit prunes before XLA counts
#: the arguments: musicgen-medium takes embeddings, so its decode step reads
#: neither the token embedding table nor the tokens
UNREAD = {("musicgen-medium", "decode_32k"): (("params", "embed"), ("tokens",))}


def meta_mesh(shape, axes):
    """A mesh whose every cell is the ``meta`` device."""
    from repro_torch.distributed.sharding import Mesh

    return Mesh(np.array([torch.device("meta")] * int(np.prod(shape)), dtype=object).reshape(shape),
                axes)


#: the attention blocks of the prefill cells in the cost comparison (see the docstring)
PREFILL_BLOCK = 8192


def _unrolled(cfg, shape_name):
    """A cell's config as the cost comparison runs it on both sides."""
    import dataclasses

    kw = dict(attn_block_q=PREFILL_BLOCK, attn_block_kv=PREFILL_BLOCK) if "prefill" in shape_name else {}
    return dataclasses.replace(cfg, scan_layers=False, unroll_loops=True, grad_accum=1, **kw)


_JAX_PRELUDE = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
from repro.analysis import roofline
from repro.launch import dryrun
from repro.configs import get_smoke_config
from repro.distributed.sharding import set_current_mesh
from repro.launch.mesh import _make_mesh
from repro.launch.specs import input_specs_for
mesh = _make_mesh((2, 2, 2), ("pod", "data", "model"))
set_current_mesh(mesh)
def compiled(cfg, name):
    cfg, shape, rules, inputs = input_specs_for(cfg, name, mesh)
    with mesh:
        return dryrun._lower(cfg, shape, inputs).compile()
out = {{}}
"""
#: XLA's argument bytes per cell of the smoke configs, and JAX's ``cells()``
_JAX_ARGS = f"""
for arch, name in {CELLS!r}:
    out[arch + " " + name] = compiled(get_smoke_config(arch), name).memory_analysis().argument_size_in_bytes
print("RESULT", json.dumps({{"args": out, "cells": list(dryrun.cells())}}))
"""
#: XLA's flops, bytes accessed and collective bytes per cell, every loop
#: unrolled (``_unrolled``)
_JAX_COSTS = f"""
for arch, name in {CELLS!r}:
    kw = dict(attn_block_q={PREFILL_BLOCK}, attn_block_kv={PREFILL_BLOCK}) if "prefill" in name else {{}}
    cfg = dataclasses.replace(get_smoke_config(arch), scan_layers=False, unroll_loops=True,
                              grad_accum=1, **kw)
    c = compiled(cfg, name)
    ca = c.cost_analysis()
    out[arch + " " + name] = {{"flops": ca["flops"], "bytes": ca["bytes accessed"],
                              "coll": roofline.collective_bytes(c.as_text())}}
print("RESULT", json.dumps({{"costs": out}}))
"""


@pytest.fixture(scope="module")
def jax_side():
    """XLA's numbers of the nine cells and JAX's ``cells()``, from two
    processes with 8 host devices run side by side (the dry-run module
    forces its own device count at import, so it is imported there and
    not here)."""
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_PRELUDE + body], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for body in (_JAX_ARGS, _JAX_COSTS)]
    out = {}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        line = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
        assert line, stderr[-3000:]
        out.update(json.loads(line[0][len("RESULT "):]))
    return out


def _pick(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_per_device_argument_bytes_equal_xla_on_a_2x2x2_mesh(jax_side, arch, shape_name):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs

    mesh = meta_mesh((2, 2, 2), ("pod", "data", "model"))
    _, _, _, inputs = specs.input_specs_for(get_smoke_config(arch), shape_name, mesh)
    assert all(t.device.type == "meta" and t.sharding.mesh is mesh
               for t in specs.tensors(inputs))
    ours = specs.per_device_bytes(inputs)
    unread = sum(specs.per_device_bytes(_pick(inputs, p))
                 for p in UNREAD.get((arch, shape_name), ()))
    assert ours - unread == jax_side["args"][f"{arch} {shape_name}"]


def test_cells_equal_jax(jax_side):
    from repro_torch.launch import dryrun

    assert [list(c) for c in dryrun.cells()] == jax_side["cells"]
    assert len(jax_side["cells"]) == 40
    assert [list(c[:2]) for c in dryrun.cells(include_skips=False)] == [
        c[:2] for c in jax_side["cells"] if not c[2]]


#: the stated bounds of the port's count over XLA's, by shape kind (measured
#: on these cells with jax 0.9.0: flops 0.69-0.89 for train and prefill,
#: 0.19-0.52 for decode; bytes 0.68-1.64).  FlopCounterMode counts the
#: matmuls and attention, a subset of the ops XLA counts, so its flops are at
#: most XLA's; they are most of XLA's where matmuls dominate (train,
#: prefill), and a smaller share of a decode step, whose softmax and cache
#: update over 32k positions XLA counts and the counter does not.  The
#: eager count reads and writes every intermediate that XLA's fusions keep
#: on chip, and XLA counts each fusion's operands in full where the eager
#: ops touch less of them, so the bytes lie within a factor of 2 of XLA's
#: either way.
FLOPS_RATIO = {"train": (0.65, 1.0), "prefill": (0.65, 1.0), "decode": (0.15, 1.0)}
BYTES_RATIO = (0.5, 2.0)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_counted_flops_and_bytes_hold_to_xla_with_every_loop_unrolled(jax_side, arch,
                                                                       shape_name):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun, specs

    mesh = meta_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg, shape, _, inputs = specs.input_specs_for(
        _unrolled(get_smoke_config(arch), shape_name), shape_name, mesh)
    counted = dryrun.count_step(cfg, shape, inputs)
    xla = jax_side["costs"][f"{arch} {shape_name}"]
    lo, hi = FLOPS_RATIO[shape.kind]
    flops = counted["flops"] / mesh.size / xla["flops"]
    assert lo <= flops <= hi, f"counted flops are {flops:.3f} of XLA's"
    nbytes = counted["bytes"] / mesh.size / xla["bytes"]
    assert BYTES_RATIO[0] <= nbytes <= BYTES_RATIO[1], f"counted bytes are {nbytes:.3f} of XLA's"


#: the stated band of the port's collective bytes over XLA's, per cell of the
#: archs the port lays out over a mesh (measured on the train, prefill and
#: decode smoke cells of qwen3-0.6b, qwen3-32b, gemma-7b and gemma3-12b on this
#: mesh, jax 0.9.0: 0.60-1.80; the MoE archs' train and decode cells 0.50-0.54,
#: as XLA on the CPU carries their bf16 all-to-alls in float32, at twice the
#: port's bytes: ``test_torch_dryrun_coll_moe.py``; the RG-LRU, xLSTM,
#: cross-attention and embedding-input cells 0.50-1.14:
#: ``test_torch_dryrun_coll_rec.py``).  The port's step is eager PyTorch over
#: DTensors: it all-gathers where GSPMD keeps a layout, reduce-scatters the
#: gradients of replicated weights that XLA all-reduces, and sums the clip's
#: squares leaf by leaf, so its kinds and counts differ from XLA's while the
#: bytes stay within a factor of 2 either way.
COLL_RATIO = (0.5, 2.0)
#: XLA's kinds that the port's step cannot send: DTensor's redistributions
#: issue no collective-permute.  XLA sends one where it splits a dim that
#: lies over ``model`` (the rope's halves of a head_dim-sharded q, the
#: recurrent blocks' shifted slices), from 1 KB (recurrentgemma-2b x
#: decode_32k) to 17 MB (its train_4k, 0.5% of the cell's bytes); the port
#: keeps those dims whole or moves them by another kind, and XLA's permutes
#: count in the band's total.
NOT_SENT = ("collective-permute",)
#: XLA's kinds of a cell that the port moves by another one: recurrentgemma-2b's
#: one kv head does not divide ``model``, so k is sharded on head_dim, and XLA
#: concatenates the rope's halves of it by all-to-alls (33.5 MB of 3.24 GB at
#: train_4k, jax 0.9.0) where the port gathers k whole; they count in the
#: band's total
XLA_ONLY = {("recurrentgemma-2b", "train_4k"): ("all-to-all",)}
#: cells held to a band of their own, each with its reason.
#: recurrentgemma-2b x decode_32k: its one kv head does not divide ``model``,
#: so the cache is sharded on head_dim.  At decode XLA all-gathers that cache
#: (41.9 MB of its 42.1 MB, jax 0.9.0) and the port all-reduces each head's
#: one row of float32 partial scores instead (``attention._per_shard``'s
#: head_dim layout: 16.8 MB, 0.40 of XLA's total), which is the layout that
#: sends the least at decode where the kv heads do not divide ``model``.
CELL_RATIO = {("recurrentgemma-2b", "decode_32k"): (0.35, 2.0)}


def port_collectives(cfg, shape_name: str, mesh) -> dict:
    """The port's collective count of a cell."""
    from repro_torch.launch import dryrun

    return dryrun.count_collectives(cfg, shape_name, mesh)


def check_collectives(got: dict, xla: dict, cell: tuple[str, str]) -> None:
    """The port's count of the (arch, shape) `cell` against XLA's
    ``collective_bytes`` (``COLL_RATIO`` or ``CELL_RATIO``, ``NOT_SENT``,
    ``XLA_ONLY``)."""
    from repro_torch.analysis import roofline

    kinds = {k: v for k, v in xla.items() if k != "_counts"}
    assert set(got["coll_by_type"]) == set(kinds) == set(roofline.COLLECTIVE_OPS)
    assert set(got["coll_counts"]) == set(kinds)
    total = sum(kinds.values())
    for kind, n in kinds.items():
        if n and kind not in NOT_SENT + XLA_ONLY.get(cell, ()):
            assert got["coll_by_type"][kind] > 0, (kind, got["coll_by_type"])
    assert all(got["coll_by_type"][kind] == 0 for kind in NOT_SENT), got["coll_by_type"]
    ratio = got["coll_bytes"] / total
    lo, hi = CELL_RATIO.get(cell, COLL_RATIO)
    assert lo <= ratio <= hi, f"collective bytes are {ratio:.3f} of XLA's"


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_collective_bytes_hold_to_xla_or_name_the_slice_that_counts_them(jax_side, arch,
                                                                          shape_name):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    kw = dict(attn_block_q=PREFILL_BLOCK, attn_block_kv=PREFILL_BLOCK) if "prefill" in shape_name else {}
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    got = port_collectives(cfg, shape_name, meta_mesh((2, 2, 2), ("pod", "data", "model")))
    check_collectives(got, jax_side["costs"][f"{arch} {shape_name}"]["coll"], (arch, shape_name))
