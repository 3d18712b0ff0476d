"""Pod-scale dry-run: run every (architecture x shape x mesh) cell's step
on ``meta`` tensors (shapes and dtypes, no storage, no card), count its
flops and bytes, reckon its per-device memory on the production mesh,
and write roofline records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # 40-cell sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod  # 512-device mesh
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --roofline   # + roofline terms
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hdc_mnist   # the paper's system

The torch counterpart of ``repro.launch.dryrun``, with its flags, cells
and record keys.  JAX lowers and compiles each cell under 512 forced host
devices; the port has no compiler to ask, so it *runs* the step function
JAX would lower (``make_train_step`` with backward and AdamW,
``transformer.prefill``, ``transformer.decode_step``) on ``meta``
tensors at the global shape, and records:

  * ``raw.flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
    the run over the mesh's devices.  It counts matmuls and attention
    only, where XLA counts every op; ``model_flops`` and
    ``useful_flops_ratio`` stand beside it, as in JAX's records;
  * ``raw.bytes``: the bytes each op reads and writes (its tensor inputs
    and outputs; views move none), over the devices: the counterpart of
    XLA's "bytes accessed";
  * ``raw.coll_bytes``, ``coll_by_type`` and ``coll_counts``: what the
    port's own sharded step sends (:func:`count_collectives`).  The step
    runs once more on ``DTensor``s over the cell's mesh (one process
    standing for rank 0 of the ``fake`` backend, ``meta`` local shards)
    inside a ``CommDebugMode`` that also sums each collective's operand
    bytes, under JAX's keys.  It runs at one and two layer groups (and
    one group and the tail), and ``roofline.combine_unrolled``
    extrapolates to full depth, as JAX's ``--roofline`` does: a
    256-rank DTensor run of the full stack costs too much host time.
    ``coll_s`` is that run's host seconds.  Every arch is counted.  The
    ``fake`` backend comes from
    ``torch.testing._internal.distributed.fake_pg`` (present in the
    H100 machine's torch 2.11 and in torch 2.13);
  * ``memory.argument_bytes``: each input leaf's shard under its spec,
    summed over params, optimizer state, batch and step: equal to XLA's
    ``argument_size_in_bytes`` for the same cell;
  * ``memory.peak_bytes_est``: the arguments' per-device bytes plus the
    run's peak of live ``meta`` storages beyond its inputs (tracked under
    a ``TorchDispatchMode``) split evenly over the devices, and that
    global peak as ``peak_bytes_global``.  The split is an estimate:
    the run is one program over the global shape, not a partitioned one.

JAX lowers unrolled variants for ``--roofline`` because XLA counts a
``while`` body once.  The port runs every layer eagerly, so the flop and
byte counters already see every layer, and ``--roofline`` fills
``terms`` straight from the counted step (``corrected`` is the raw
count; its collective bytes are the extrapolated ones above).

This module sets no environment variable at import (JAX's first lines
force its host device count) and needs no card: the meta run is the
exception to the port's "runs on the card unless given the CPU".
:func:`run_hdc` is the one part that runs on a device: the paper's fit
at the dry-run's size, on the card by default.

Records land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.sharding import (
    Mesh,
    NamedSharding,
    get_current_mesh,
    set_current_mesh,
)
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.launch.specs import input_specs_for, per_device_bytes, tensors
from repro_torch.models import transformer
from repro_torch.models.config import LONG_CONTEXT_OK, SHAPES
from repro_torch.optim import OptimizerConfig
from repro_torch.training.step import make_train_step

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
COLL_NOTE = ("counted: the collectives the port's step sends on DTensors over the cell's mesh "
             "(fake backend, meta shards), at 1 and 2 layer groups, extrapolated to full depth "
             "(roofline.combine_unrolled); operand bytes per device")


def production_meta_mesh(multi_pod: bool = False):
    """The production mesh (16 x 16, or 2 x 16 x 16) over the ``meta`` device."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=[torch.device("meta")] * n)


class StepCounter(TorchDispatchMode):
    """Live ``meta`` storage bytes (current and peak) and the bytes each op
    reads and writes, over one run.  A storage is live from the op that
    makes it until its last tensor is freed."""

    def __init__(self, inputs):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = self.peak = self.accessed = 0
        for t in tensors(inputs):
            self._track(t)
        self.inputs = self.current

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = tensors(out)
        if not func.is_view:
            ins = tensors((args, kwargs))
            self.accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


#: c10d functional ops -> JAX's collective kinds
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode`` that also sums each collective's operand bytes
    (its local input: what XLA's HLO gives a collective's operand) by
    JAX's kind.  DTensor's all-to-all on a ``cpu`` mesh is an all-gather
    and a chunk (gloo has none); :meth:`labelled` counts it as the
    all-to-all a card's mesh issues, with the same operand."""

    def __init__(self):
        super().__init__()
        self.nbytes = {k: 0 for k in roofline.COLLECTIVE_OPS}
        self.counts = {k: 0 for k in roofline.COLLECTIVE_OPS}
        self._label: str | None = None

    @contextlib.contextmanager
    def labelled(self):
        import torch.distributed.tensor.placement_types as pt

        orig = getattr(pt, "shard_dim_alltoall", None)
        if orig is None:
            yield
            return

        def alltoall(*args, **kwargs):
            self._label = "all-to-all"
            try:
                return orig(*args, **kwargs)
            finally:
                self._label = None

        pt.shard_dim_alltoall = alltoall
        try:
            yield
        finally:
            pt.shard_dim_alltoall = orig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "").split(".")[0]
        ns = getattr(func, "namespace", "")
        if ns in ("_c10d_functional", "c10d_functional"):
            if name in _FUNCOL_KIND:
                kind = self._label or _FUNCOL_KIND[name]
                ins = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
                self.nbytes[kind] += sum(t.numel() * t.element_size() for t in ins)
                self.counts[kind] += 1
            elif any(w in name for w in ("all_", "reduce", "scatter", "gather", "permute",
                                         "broadcast")):
                raise NotImplementedError(f"collective {func} has no JAX kind to count it under")
        return super().__torch_dispatch__(func, types, args, kwargs)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A default process group of `world_size` ranks on the ``fake``
    backend, this process rank 0: collectives return at once and move
    nothing, so one process runs rank 0's part of a sharded step."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the collective count starts its own fake process group; "
                           "a process group is already up")
    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dtensor_inputs(inputs, mesh: Mesh):
    """The ``meta`` inputs as ``DTensor``s of their shards on `mesh` (a
    mesh of ranks), each laid out by its ``.sharding``'s spec."""
    from torch.distributed.tensor import DTensor

    from repro_torch.analysis.roofline import shard_numel

    def conv(t):
        if not isinstance(t, torch.Tensor):
            return t
        sh = NamedSharding(mesh, t.sharding.spec)
        spec = tuple(sh.spec) + (None,) * (t.ndim - len(sh.spec))
        local = torch.empty([shard_numel((d,), (e,), mesh.shape) for d, e in zip(t.shape, spec)],
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh.device_mesh(), sh.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tree_map(conv, inputs)


def _count_variant(cfg, shape_name: str, mesh: Mesh) -> dict:
    cfg, shape, _, inputs = input_specs_for(cfg, shape_name, mesh)
    ranked = Mesh(mesh.devices, mesh.axis_names,
                  ranks=np.arange(mesh.size).reshape(mesh.devices.shape))
    counter = CollectiveCounter()
    with counter, counter.labelled():
        _run(cfg, shape, _dtensor_inputs(inputs, ranked))
    out = {f"coll/{k}": float(v) for k, v in counter.nbytes.items()}
    out.update({f"count/{k}": float(v) for k, v in counter.counts.items()})
    return out


def count_collectives(cfg, shape_name: str, mesh: Mesh) -> dict:
    """The collectives of the cell's step on `mesh` (a ``meta`` mesh of
    the cell's shape): per device, ``coll_bytes`` (operand bytes),
    ``coll_by_type`` and ``coll_counts`` under JAX's keys, and ``coll_s``,
    the host seconds of the count.  The step runs sharded on ``DTensor``s
    at one and two layer groups (and one group and the tail, where there
    is one) and is extrapolated to full depth."""
    t0 = time.perf_counter()
    period, tail_len = cfg.period, len(cfg.tail_pattern)

    def variant(n_layers: int) -> dict:
        return _count_variant(dataclasses.replace(cfg, n_layers=n_layers, grad_accum=1),
                              shape_name, mesh)

    with fake_group(mesh.size):
        u1 = variant(period)
        u2 = variant(2 * period)
        tail = variant(period + tail_len) if tail_len else None
    keys = tuple(u1)
    total = roofline.combine_unrolled(u1, u2, cfg.n_groups, tail, {}, keys=keys)
    by_type = {k: int(total[f"coll/{k}"]) for k in roofline.COLLECTIVE_OPS}
    return {
        "coll_bytes": float(sum(by_type.values())),
        "coll_by_type": by_type,
        "coll_counts": {k: int(total[f"count/{k}"]) for k in roofline.COLLECTIVE_OPS},
        "coll_s": time.perf_counter() - t0,
    }


def _run(cfg, shape, inputs):
    """Run the step function JAX's dry-run lowers for the shape kind."""
    if shape.kind == "train":
        step_fn = make_train_step(cfg, OptimizerConfig())
        return step_fn(inputs["params"], inputs["opt_state"], inputs["batch"], 0)
    if shape.kind == "prefill":
        return transformer.prefill(cfg, inputs["params"], inputs["batch"])
    extra = {"embeddings": inputs["embeddings"]} if cfg.input_mode == "embeddings" else {}
    return transformer.decode_step(cfg, inputs["params"], inputs["state"], inputs["tokens"],
                                   **extra)


def _donated(shape, inputs) -> dict:
    """The inputs a step updates in place (JAX's donated arguments)."""
    if shape.kind == "train":
        return {"params": inputs["params"], "opt_state": inputs["opt_state"]}
    if shape.kind == "decode":
        return {"state": inputs["state"]}
    return {}


def count_step(cfg, shape, inputs) -> dict:
    """Run one step on meta tensors; its flops, bytes accessed and live
    storage peak (global: the run is one program over the global shape)."""
    counter = StepCounter(inputs)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, counter:
        out = _run(cfg, shape, inputs)
    held = {t.untyped_storage()._cdata for t in tensors(inputs)}
    out_bytes = sum(t.numel() * t.element_size() for t in tensors(out)
                    if t.untyped_storage()._cdata not in held)
    return {
        "run_s": time.perf_counter() - t0,
        "flops": float(flops.get_total_flops()),
        "bytes": float(counter.accessed),
        "inputs_global": counter.inputs,
        "peak_global": counter.peak,
        "outputs_global": out_bytes,
    }


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    do_roofline: bool = False,
    verbose: bool = True,
    overrides: dict | None = None,
) -> dict:
    """Run one cell's step on meta tensors and record it.

    `overrides` patches the registered config (perf-iteration variants)."""
    mesh = production_meta_mesh(multi_pod)
    n_chips = mesh.size
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single",
        "chips": n_chips, "overrides": overrides or {},
    }
    previous = get_current_mesh()
    set_current_mesh(mesh)
    try:
        base_cfg = get_config(arch)
        if overrides:
            base_cfg = dataclasses.replace(base_cfg, **overrides)
        t0 = time.perf_counter()
        cfg, shape, rules, inputs = input_specs_for(base_cfg, shape_name, mesh)
        record["lower_s"] = round(time.perf_counter() - t0, 2)  # building the specs
        record["compile_s"] = None  # nothing is compiled
        counted = count_step(cfg, shape, inputs)
        record["run_s"] = round(counted["run_s"], 2)

        args = per_device_bytes(inputs)
        alias = per_device_bytes(_donated(shape, inputs))
        temp_global = max(counted["peak_global"] - counted["inputs_global"], 0)
        record["memory"] = {
            "argument_bytes": args,
            "output_bytes": alias + counted["outputs_global"] // n_chips,
            "temp_bytes": temp_global // n_chips,
            "alias_bytes": alias,
            "peak_bytes_est": args + temp_global // n_chips,
            "peak_bytes_global": counted["peak_global"],
            "estimate": "argument and alias bytes exact from the specs; output and temp bytes "
                        "the global run's split evenly over the devices",
        }
        coll = count_collectives(cfg, shape_name, mesh)
        record["raw"] = {
            "flops": counted["flops"] / n_chips,
            "bytes": counted["bytes"] / n_chips,
            "coll_bytes": coll["coll_bytes"],
            "coll_by_type": coll["coll_by_type"],
            "coll_counts": coll["coll_counts"],
            "coll_note": COLL_NOTE,
            "coll_s": round(coll["coll_s"], 2),
            "flops_global": counted["flops"],
            "flops_counted": "FlopCounterMode: matmuls and attention only",
        }
        mf = roofline.model_flops(cfg, shape, n_chips)
        record["model_flops"] = mf
        record["useful_flops_ratio"] = mf / counted["flops"] if counted["flops"] else 0.0

        if verbose:
            mem = record["memory"]
            print(
                f"  [{describe(mesh)}] run {record['run_s']:.1f}s | args "
                f"{mem['argument_bytes']/2**30:.2f} GiB  temp {mem['temp_bytes']/2**30:.2f} GiB  "
                f"peak~{mem['peak_bytes_est']/2**30:.2f} GiB | flops {counted['flops']:.3e} "
                f"(model {mf:.3e})", flush=True,
            )

        if do_roofline:
            raw = record["raw"]
            record["corrected"] = {k: raw[k] for k in ("flops", "bytes", "coll_bytes")}
            record["roofline_s"] = 0.0  # eager: every layer was counted, no variants to run
            terms = roofline.RooflineTerms(raw["flops"], raw["bytes"], raw["coll_bytes"])
            record["terms"] = terms.asdict()
            if verbose:
                print(
                    f"  roofline: compute {terms.compute_s*1e3:.2f} ms | memory "
                    f"{terms.memory_s*1e3:.2f} ms | collective {terms.collective_s*1e3:.2f} ms "
                    f"-> {terms.dominant}-bound; useful/counted flops = "
                    f"{record['useful_flops_ratio']:.2f}", flush=True,
                )
    finally:
        set_current_mesh(previous)
    return record


HDC_IMAGES, HDC_FEATURES, HDC_CLASSES = 65536, 784, 16


def hdc_data():
    """The dry-run's synthetic images (HDC_IMAGES x HDC_FEATURES integer
    intensities in [0, 255] as float32) and labels in [0, HDC_CLASSES),
    made with numpy from seed 0."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (HDC_IMAGES, HDC_FEATURES)).astype(np.float32)
    labels = rng.integers(0, HDC_CLASSES, HDC_IMAGES).astype(np.int32)
    return images, labels


def run_hdc(multi_pod: bool = False, d: int = 8192, verbose: bool = True, device=None) -> dict:
    """The paper's own system at the dry-run's size: the uHD single-pass
    fit of 65,536 images x 784 features into 16 classes.

    JAX only compiles this fit for the production mesh.  The port runs it
    on one device (the card by default: kernel 3, ``fit_bundle``, on its
    histogram path, int8 table and 16 classes; the plain version on the
    CPU) and records, beside it, the per-device bytes the production
    mesh would hold (images and labels over the batch axes, the (784, D)
    table and the class sums over ``model``), the fit's measured ms (the
    median of 5 fits after a first one by CUDA events on the card; one fit
    by the host's clock on the CPU), its one-card bound and the class
    sums' sha256."""
    from repro_torch.core import HDCConfig, HDCModel, hdc_model
    from repro_torch.core.hdc_model import resolve_device

    dev = resolve_device(device)
    n, h, c = HDC_IMAGES, HDC_FEATURES, HDC_CLASSES
    reps = 5 if dev.type == "cuda" else 1
    mesh = production_meta_mesh(multi_pod)
    ms = mesh.shape
    bsz = ms.get("pod", 1) * ms["data"]
    cfg = HDCConfig(n_features=h, n_classes=c, d=d)
    images, labels = hdc_data()
    model = HDCModel.create(cfg, device=dev)
    table = model.codebooks["sobol"]
    x, y = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)

    def fit():
        return hdc_model.fit(model, x, y)

    fitted = fit()  # builds the kernels on a card's first launch
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fitted = fit()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fitted = fit()
            times.append((time.perf_counter() - t0) * 1e3)
    sums = fitted.class_sums.cpu().numpy()
    msize = ms["model"] if d % ms["model"] == 0 else 1
    rec = {
        "arch": "hdc_mnist", "shape": f"fit_{n}xD{d}",
        "mesh": "multi" if multi_pod else "single",
        "chips": mesh.size,
        "device": str(dev),
        "per_device_bytes": {
            "images": n // bsz * h * 4,
            "labels": n // bsz * 4,
            "sobol": h * (d // msize) * table.element_size(),
            "class_sums": c * (d // msize) * 4,
        },
        "fit_ms": float(np.median(times)),
        "fit_ms_all": times,
        "timed_by": "cuda events" if dev.type == "cuda" else "perf_counter",
        "bound_ms": roofline.fit_bundle_bound(n, h, d, c, table.element_size()) * 1e3,
        "class_sums_sha256": hashlib.sha256(sums.astype("<i4").tobytes()).hexdigest(),
        "n_seen": fitted.n_examples,
    }
    if verbose:
        print(
            f"  hdc fit [{describe(mesh)} reckoned; run on {dev}]: {rec['fit_ms']:.3f} ms "
            f"(bound {rec['bound_ms']:.3f} ms) | per device: images "
            f"{rec['per_device_bytes']['images']/2**20:.2f} MiB, table "
            f"{rec['per_device_bytes']['sobol']/2**10:.1f} KiB | sums "
            f"{rec['class_sums_sha256'][:16]}", flush=True,
        )
    return rec


def cells(include_skips: bool = True):
    for arch in ARCHS:
        for shape_name in SHAPES:
            skip = shape_name == "long_500k" and arch not in LONG_CONTEXT_OK
            if skip and not include_skips:
                continue
            yield arch, shape_name, skip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--device", default=None,
                    help="--arch hdc_mnist only: cuda (default) or cpu")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    todo: list[tuple[str, str, bool]] = []
    if args.arch == "hdc_mnist":
        for mp in meshes:
            rec = run_hdc(multi_pod=mp, device=args.device)
            path = out_dir / f"hdc_mnist__fit__{rec['mesh']}.json"
            path.write_text(json.dumps(rec, indent=1))
        return 0
    if args.all:
        todo = list(cells())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        skip = args.shape == "long_500k" and args.arch not in LONG_CONTEXT_OK
        todo = [(args.arch, args.shape, skip)]

    failures = 0
    for arch, shape_name, skip in todo:
        for mp in meshes:
            mesh_name = "multi" if mp else "single"
            tag = f"{arch} x {shape_name} [{mesh_name}]"
            path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
            if args.skip_existing and path.exists():
                rec = json.loads(path.read_text())
                if "skipped" in rec or "memory" in rec and (not args.roofline or "terms" in rec):
                    print(f"SKIP (exists) {tag}")
                    continue
            if skip:
                print(f"SKIP {tag}: long_500k needs sub-quadratic attention "
                      f"(pure full-attention arch; see DESIGN.md)")
                path.write_text(json.dumps({
                    "arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "skipped": "full-attention arch at 500k context",
                }, indent=1))
                continue
            print(f"RUN  {tag}", flush=True)
            try:
                rec = run_cell(arch, shape_name, multi_pod=mp, do_roofline=args.roofline)
                path.write_text(json.dumps(rec, indent=1))
            except Exception:
                failures += 1
                print(f"FAIL {tag}")
                traceback.print_exc()
    print(f"\ndone; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
