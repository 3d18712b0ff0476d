"""The paper's system as a distributed workload: sharded single-pass uHD
training with one (C, D) sum over the batch shards, plus an `HDCModel`
checkpoint round-trip onto the mesh.

    PYTHONPATH=src python -m repro_torch.examples.hdc_at_scale              # on the card
    PYTHONPATH=src python -m repro_torch.examples.hdc_at_scale --device cpu

The port of ``examples/hdc_at_scale.py``, with its sizes and printed
lines, but one: the JAX script loops over two of its backends (the
MXU-shaped unary matmul and the Pallas kernel) and prints a line each.
The port has one datapath per device (the CUDA kernels on a card, the
plain PyTorch versions on the CPU), so it prints one line.  The fit runs
through ``partial_fit_sharded`` on the mesh of the devices present (a
(1, 1) mesh on one card or the CPU), and its closing hint names the
port's dry-run.
"""

from __future__ import annotations

import argparse
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core import HDCConfig, HDCModel, partial_fit_sharded, resolve_device
    from repro_torch.data import load_dataset
    from repro_torch.distributed.sharding import get_current_mesh, set_current_mesh
    from repro_torch.launch.mesh import mesh_for

    dev = resolve_device(args.device)
    mesh = mesh_for(devices=[dev] if dev.type == "cpu" else None)  # every device present
    previous = get_current_mesh()
    set_current_mesh(mesh)
    try:
        print("mesh:", mesh.shape)

        ds = load_dataset("synth_mnist", n_train=2048, n_test=512)
        tag = "CUDA kernels" if dev.type == "cuda" else "plain PyTorch datapath"
        cfg = HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=1024)
        model = HDCModel.create(cfg, device=mesh.devices.flat[0]).shard(mesh)  # D over "model"
        model = partial_fit_sharded(model, ds.train_images[:512], ds.train_labels[:512],
                                    mesh=mesh)
        acc = model.evaluate(ds.test_images[:256], ds.test_labels[:256])
        print(f"{tag:28s}: accuracy {acc:.4f}")

        # a trained model is one checkpoint: save it and restore it onto the mesh
        with tempfile.TemporaryDirectory() as ckpt_dir:
            model.save(ckpt_dir, step=0)
            restored = HDCModel.load(ckpt_dir, mesh=mesh)
            same = restored.evaluate(ds.test_images[:256], ds.test_labels[:256]) == acc
            print(f"checkpoint round-trip onto mesh: predictions identical = {same}")
    finally:
        set_current_mesh(previous)

    print("\nFor the 256/512-device version of this exact computation see:")
    print("  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hdc_mnist")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
