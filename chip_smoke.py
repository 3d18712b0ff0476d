#!/usr/bin/env python3
"""Drive the port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each printed as one JSON object per line:

1. device: the card's name and count, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels of ``repro_torch`` built from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, with the seconds taken and ptxas's register and
   shared-memory lines;
3. kernels: each kernel against its plain PyTorch version on the card at the
   serving path's shapes and at ragged ones, for exact equality (the datapath
   is integer: the tolerance is 0), then timed with CUDA events;
4. slice: ``repro_torch.launch.serve_hdc``'s smoke at the JAX smoke's
   configuration (synth_mnist, uhd_dynamic, d=8192, levels=16, 1024 training
   images, 256 requests in batches of 64), with every kernel's launch count
   read around it, the class sums of both steps held against checksums from
   the JAX package, the packed path against ``HDCModel.predict``, and
   ``search(k=3)[:, 0]`` against ``predict``;
5. profile: ``torch.profiler`` over 16 steady predict batches of 64: device
   time per batch by kernel, and the device's idle share of the wall time.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a card, or without the rest of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Class-sum checksums of the smoke configuration, computed by the JAX package
# on the CPU (sha256 of the (10, 8192) int32 class sums, little-endian):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import hashlib,numpy as np; \
#   from repro.core import HDCConfig,HDCModel; from repro.data import load_dataset; \
#   ds=load_dataset('synth_mnist',n_train=1024,n_test=256); \
#   c=HDCConfig(n_features=784,n_classes=10,d=8192,levels=16,encoder='uhd_dynamic'); \
#   m0=HDCModel.create(c).fit(ds.train_images[:512],ds.train_labels[:512]); \
#   m1=m0.partial_fit(ds.train_images[512:],ds.train_labels[512:]); \
#   [print(hashlib.sha256(np.asarray(m.class_sums).astype('<i4').tobytes()).hexdigest()) for m in (m0,m1)]"
JAX_CLASS_SUMS_SHA256 = (
    "85588503a413500219b41aaf77a3692899c31e4ba056c5a6fc3782237c122f1a",  # step 0
    "a1a6b68d2bf99548f4641ea18f8e84e2e7ef1c4a4607d7d5bc44fe416e06f3f7",  # step 1
)
# Served accuracy of `python -m repro.launch.serve_hdc --smoke --encoder uhd_dynamic
# --d 8192 --batch 64` (the JAX package on the CPU).
JAX_SERVED_ACCURACY = 0.8516

# Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).  Compare-count
# and popcount work runs on the CUDA cores: 64 int32 lanes an SM against 128 fp32
# lanes and no fused multiply-add, so the int32 issue rate is a quarter of the
# 67 TFLOP/s fp32 rate.  A popcount is counted as one op at that rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

KERNELS = {
    "encode_bundle_dynamic": dict(
        source="src/repro_torch/kernels/csrc/encode_bundle.cu",
        replaces="src/repro/kernels/encode_bundle.py:121",
    ),
    "fit_bundle_dynamic": dict(
        source="src/repro_torch/kernels/csrc/encode_bundle.cu",
        replaces="src/repro/kernels/encode_bundle.py:261",
    ),
    "hamming_topk": dict(
        source="src/repro_torch/kernels/csrc/hamming_topk.cu",
        replaces="src/repro/kernels/hamming_topk.py:80",
    ),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds of fn over `iters` launches, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(torch, ops, ref, sobol, unary) -> dict[str, dict]:
    """Each kernel against its plain version; times at the serving shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict[str, dict] = {}

    def rand_x(b, h, levels=16):
        return torch.randint(0, levels + 1, (b, h), generator=gen, device=dev, dtype=torch.int32)

    def direction(h, levels=16):
        return torch.from_numpy(sobol.quantized_direction_matrix(h, levels, seed=0)).to(dev)

    def check(name, got, want, shape, timed=None):
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        emit("kernel_check", kernel=name, shape=shape, equal=equal, max_abs_err=err)
        if not equal:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}")
        r = results.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timed is not None:
            kernel_fn, plain_fn, n_bytes, n_ops = timed
            ms = time_ms(torch, kernel_fn, 50)
            plain = time_ms(torch, plain_fn, 3)
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            emit("kernel_time", kernel=name, shape=shape, ms=ms, plain_ms=plain,
                 bound_ms=b_ms, bound_by=b_by)
            r.setdefault("timed", {})[json.dumps(shape)] = dict(
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, shape=shape
            )

    # -- encode_bundle_dynamic: the serving batch, then ragged cases, one with
    #    8-bit thresholds (levels=256) --------------------------------------
    for b, h, d, skip, levels in [(64, 784, 8192, 1, 16), (37, 100, 1000, 1000, 16),
                                  (33, 113, 257, 0, 256)]:
        x, dirs = rand_x(b, h, levels), direction(h, levels)
        k_fn = lambda: ops.encode_bundle_dynamic(x, dirs, d, skip=skip)  # noqa: E731
        p_fn = lambda: ref.encode_bundle_dynamic(x, dirs, d, skip=skip)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        n_bytes = b * h * 4 + h * 32 + b * d * 4
        check("encode_bundle_dynamic", [got], [p_fn()],
              dict(B=b, H=h, D=d, skip=skip, levels=levels),
              (k_fn, p_fn, n_bytes, 2 * b * h * d) if b == 64 else None)

    # -- fit_bundle_dynamic: the fit batches, then ragged with bad labels ----
    for b, h, d, c, skip in [(512, 784, 8192, 10, 1), (4096, 784, 8192, 10, 1),
                             (37, 100, 1000, 10, 1000)]:
        x, dirs = rand_x(b, h), direction(h)
        labels = torch.randint(0, c, (b,), generator=gen, device=dev, dtype=torch.int32)
        if b == 37:
            labels[::5] = -1  # out of range: contributes nothing, written nowhere
            labels[2::7] = c
        k_fn = lambda: ops.fit_bundle_dynamic(x, dirs, labels, c, d, skip=skip)  # noqa: E731
        p_fn = lambda: ref.fit_bundle_dynamic(x, dirs, labels, c, d, skip=skip)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        n_bytes = b * h * 4 + h * 32 + b * 4 + c * d * 4
        check("fit_bundle_dynamic", [got], [p_fn()], dict(B=b, H=h, D=d, C=c, skip=skip),
              (k_fn, p_fn, n_bytes, 2 * b * h * d + b * d) if b != 37 else None)

    # -- hamming_topk: predict (k=1), a 64 MiB store, crafted ties at k=C ----
    for b, c, d, k in [(64, 10, 8192, 1), (64, 65536, 8192, 8), (16, 1000, 1000, 1000)]:
        w = unary.n_words(d)
        bits_q = torch.rand((b, d), generator=gen, device=dev) < 0.5
        bits_r = torch.rand((c, d), generator=gen, device=dev) < 0.5
        if d == 1000:
            bits_r[c // 2] = bits_r[1]  # duplicate rows: equal distances
            bits_r[c - 1] = bits_r[0]
            bits_r[3] = bits_q[0]  # an exact match
            bits_r[5:9] = bits_r[4]  # a run of ties
        q, rows = unary.pack_bits(bits_q), unary.pack_bits(bits_r)
        k_fn = lambda: ops.hamming_topk(q, rows, d, k)  # noqa: E731
        p_fn = lambda: ref.hamming_topk(q, rows, d, k)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        want = ref.hamming_topk_oracle(q, rows, d, k) if c <= 1000 else p_fn()
        n_bytes = b * w * 4 + c * w * 4 + 2 * b * k * 4
        check("hamming_topk", list(got), list(want), dict(B=b, C=c, D=d, k=k),
              (k_fn, p_fn, n_bytes, 3 * b * c * w) if d == 8192 else None)
    return results


def slice_phase(torch, ops, serve_hdc) -> tuple[dict, dict]:
    """The serving smoke at the JAX smoke's configuration, launches counted."""
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    args = serve_hdc.parser().parse_args([
        "--smoke", "--dataset", "synth_mnist", "--encoder", "uhd_dynamic", "--d", "8192",
        "--levels", "16", "--n-train", "1024", "--requests", "256", "--batch", "64",
        "--device", "cuda", "--ckpt", str(ckpt),
    ])
    ops.reset_launches()
    result = serve_hdc.smoke(args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    emit("slice_launches", launches=launches)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"the serving path launched no {missing} kernel")

    for step, (model, want) in enumerate(zip(result.models, JAX_CLASS_SUMS_SHA256)):
        got = hashlib.sha256(model.class_sums.cpu().numpy().astype("<i4").tobytes()).hexdigest()
        emit("class_sums", step=step, sha256=got, jax_sha256=want, equal=got == want)
        if got != want:
            raise AssertionError(f"step {step} class sums differ from the JAX package's")

    engine = result.engines[1]
    idx, dist = engine.search(result.probe, 3)
    labels = engine.predict(result.probe)
    if not (idx[:, 0] == labels).all():
        raise AssertionError("search(k=3)[:, 0] differs from predict")
    if not ((dist[:, :-1] <= dist[:, 1:]).all() and (dist >= 0).all()):
        raise AssertionError("search distances are not ascending")

    batch_ms = [t * 1e3 for s in result.serve for t in s.batch_s]
    n_served = sum(len(s.labels) for s in result.serve)
    serve_s = sum(s.wall_s for s in result.serve)
    emit(
        "slice", accuracy=result.accuracy, jax_accuracy=JAX_SERVED_ACCURACY,
        n_requests=n_served, batch=args.batch, fit_s=result.fit_s[0],
        partial_fit_s=result.fit_s[1], batch_ms_mean=sum(batch_ms) / len(batch_ms),
        batch_ms_max=max(batch_ms), batch_ms_first=batch_ms[0], img_per_s=n_served / serve_s,
        packed_parity=True, search_top1_equals_predict=True,
    )
    return launches, result


def profile_phase(torch, result, batch: int) -> None:
    """Device time of steady-state predict batches by kernel, and the
    device's idle share of the batch wall time (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    engine = result.engines[1]
    images = result.probe[:batch]
    engine.predict(images)
    torch.cuda.synchronize()
    n = 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.predict(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    rows = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    if not rows:
        emit("profile", batch=batch, batches=n, wall_ms_per_batch=wall_us / n / 1e3,
             device_ms_per_batch="not measured", idle_share="not measured")
        return
    emit(
        "profile", batch=batch, batches=n, wall_ms_per_batch=wall_us / n / 1e3,
        device_ms_per_batch=device_us / n / 1e3, idle_share=1.0 - device_us / wall_us,
        top=[{"name": k[:90], "ms_per_batch": t / n / 1e3, "calls_per_batch": c / n}
             for k, t, c in rows[:12]],
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import sobol, unary
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import serve_hdc

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    ptxas = [
        line.strip()
        for log in _build.build_info.get("logs", {}).values()
        for line in log.splitlines()
        if "Compiling entry" in line or "registers" in line or "spill" in line
    ]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_info["seconds"],
         cached=_build.build_info["cached"], ptxas=ptxas)

    results = kernel_phase(torch, ops, ref, sobol, unary)
    launches, result = slice_phase(torch, ops, serve_hdc)
    profile_phase(torch, result, 64)

    main_shape = {
        "encode_bundle_dynamic": {"B": 64, "H": 784, "D": 8192, "skip": 1, "levels": 16},
        "fit_bundle_dynamic": {"B": 512, "H": 784, "D": 8192, "C": 10, "skip": 1},
        "hamming_topk": {"B": 64, "C": 10, "D": 8192, "k": 1},
    }
    line = []
    for name, meta in KERNELS.items():
        r = results[name]
        t = r["timed"][json.dumps(main_shape[name])]
        line.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"], "equal": True,
            "other_shapes": [v for k, v in r["timed"].items() if k != json.dumps(main_shape[name])],
        })
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
