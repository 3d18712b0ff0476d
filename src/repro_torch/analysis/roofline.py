"""Roofline terms of a step on the NVIDIA H100 SXM (the torch counterpart of
``repro.analysis.roofline``, whose terms are the TPU v5e's).

Three terms per (arch x shape x mesh), all in seconds a step:

    compute    = flops_per_device      / PEAK_FLOPS   (989 TFLOP/s bf16 dense)
    memory     = bytes_per_device      / HBM_BW       (3.35 TB/s)
    collective = coll_bytes_per_device / LINK_BW      (450 GB/s, NVLink 4, one way)

The constants are NVIDIA's data-sheet peaks of one H100 SXM at its 700 W
limit, not measurements.  The integer rates beside them are the bounds of
the HDC kernels (``chip_smoke.py`` reads them from here):

  * ``INT32_OPS_PER_S``: compare-count work on the CUDA cores, 64 int32
    lanes an SM against 128 fp32 lanes and no fused multiply-add, so a
    quarter of the 67 TFLOP/s fp32 rate;
  * ``POPC_PER_S``: popcounts run on a pipe of their own at 16 results
    a clock an SM (compute capability 9.0, the CUDA C++ Programming
    Guide's table of arithmetic instruction throughput), a quarter of the
    int32 lanes at the same clock;
  * ``INT8_TC_OPS_PER_S``: the int8 tensor cores' dense rate (the same
    data sheet); a multiply and an add count as 2 ops.

The JAX package reads the third term, the collective bytes of the step,
from XLA's partitioned HLO (``collective_bytes(hlo_text)``).  The port
compiles no HLO; its dry-run counts the collectives its own sharded step
sends instead (``launch.dryrun.count_collectives``): the step runs on
``DTensor``s over the cell's mesh under the ``fake`` process-group
backend, and every collective it issues, backward included, is summed by
its operand bytes under JAX's keys (:data:`COLLECTIVE_OPS`).  That
covers the archs whose blocks the port lays out over a mesh (the dense
self-attention ones, slice 10); the others keep the term at 0 and say
why in each record.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

PEAK_FLOPS = 989e12  # bf16 dense FLOP/s of one H100 SXM
HBM_BW = 3.35e12  # bytes/s of its HBM3
LINK_BW = 450e9  # bytes/s of NVLink 4, one direction
INT32_OPS_PER_S = 67e12 / 4
POPC_PER_S = INT32_OPS_PER_S * 16 / 64
INT8_TC_OPS_PER_S = 1979e12

#: the collective kinds of JAX's records (``coll_by_type``'s keys)
COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def _axes_size(entry, mesh_shape: dict[str, int]) -> int:
    """Devices a spec entry (None, an axis name, or a tuple of them) splits over."""
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh_shape[a] for a in names)


def shard_numel(shape, spec, mesh_shape: dict[str, int]) -> int:
    """Elements of one device's shard of a tensor of `shape` under `spec`
    (a dimension that does not divide keeps its ceiling, as XLA pads)."""
    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n *= -(-dim // _axes_size(entry, mesh_shape))
    return n


def fit_bundle_work(b: int, h: int, d: int, c: int, table_bytes: int = 1) -> tuple[int, int]:
    """(bytes, operations) of fitting `b` images of `h` features at width
    `d` into `c` classes with ``fit_bundle`` (kernel 3): the bytes it must
    move (float32 images, the (h, d) table of `table_bytes`-byte entries,
    int32 labels, int32 class sums), and its compares (one quantization an
    image feature, one compare-count a class, feature and dimension on its
    histogram path)."""
    return b * h * 4 + h * d * table_bytes + b * 4 + c * d * 4, b * h + c * h * d


def fit_bundle_bound(b: int, h: int, d: int, c: int, table_bytes: int = 1) -> float:
    """The least seconds one H100 takes for :func:`fit_bundle_work`: its
    bytes over HBM's rate or its compares over the int32 rate, whichever
    is larger."""
    n_bytes, n_ops = fit_bundle_work(b, h, d, c, table_bytes)
    return max(n_bytes / HBM_BW, n_ops / INT32_OPS_PER_S)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float

    @property
    def compute_s(self) -> float:
        return self.flops_dev / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_dev / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bound_s(self) -> float:
        """Step time lower bound if the three units never overlap-stall:
        max of the terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def asdict(self) -> dict[str, Any]:
        return {
            "flops_dev": self.flops_dev,
            "bytes_dev": self.bytes_dev,
            "coll_bytes_dev": self.coll_bytes_dev,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
        }


def model_flops(cfg, shape, n_chips: int) -> float:
    """Useful model FLOPs per step: 6*N*D (dense) / 6*N_active*D (MoE).

    decode: D = batch tokens per step; train has the 3x backward factor
    already folded into the 6 (2 fwd + 4 bwd per param per token); for
    inference kinds we use 2*N*D.
    """
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def combine_unrolled(u1: dict, u2: dict, n_groups: int, tail: dict | None, full: dict,
                     keys=("flops", "bytes", "coll_bytes")):
    """Reconstruct loop-corrected totals from the unrolled variants.

    u1/u2/tail/full are dicts with the `keys` (per-device; by default
    flops, bytes, coll_bytes): u1 and u2 of the step at one and two layer
    groups, tail at one group and the tail.  Returns the corrected totals
    dict.  The port's dry-run counts flops and bytes with every layer run
    eagerly, so those need no correction; its collective count runs the
    sharded step at one and two groups and extrapolates here.
    """
    out = {}
    for k in keys:
        body = max(u2[k] - u1[k], 0.0)
        outside = max(u1[k] - body, 0.0)
        # tail variant is unrolled (period + tail) layers: outside+body+tail
        tail_cost = max(tail[k] - u1[k], 0.0) if tail else 0.0
        out[k] = outside + n_groups * body + tail_cost
        out[f"{k}_body"] = body
        out[f"{k}_outside"] = outside
    out["raw_full"] = {k: full.get(k) for k in keys}
    return out
