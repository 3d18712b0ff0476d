"""Quickstart: uHD image classification in ~30 lines (the paper, end to end).

The whole API is two objects: `HDCConfig` (static settings) and
`HDCModel` (codebooks + class-hypervector state on one device, with
`fit` / `partial_fit` / `predict` / `evaluate` / `save` / `load`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart              # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The port of ``examples/quickstart.py``, with its sizes and printed
lines.  The datapath follows the device: on a card the fit and encode
run the hand-written CUDA kernels (and the baseline's, kernels 7 and 8),
on the CPU their plain PyTorch versions.

Next steps: `repro_torch.examples.serve_http` puts a trained model
behind HTTP; `repro_torch.examples.online_learning` keeps it learning
from labeled feedback traffic after deployment;
`repro_torch.examples.vector_search` runs the same packed store as a
top-k associative memory (classify is its k=1 case) through
`search_packed` and `ItemMemory`; `repro_torch.examples.scrape_metrics`
walks the server's `/metrics` and `/v1/traces`.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core import HDCConfig, HDCModel, baseline_iterative_search, resolve_device
    from repro_torch.data import load_dataset

    dev = resolve_device(args.device)

    # 1. data: MNIST if $REPRO_DATA_DIR has it, else the synthetic analogue
    ds = load_dataset("mnist", n_train=2048, n_test=512)
    print(f"dataset: {ds.name} ({'synthetic' if ds.synthetic else 'real'}), "
          f"{ds.n_features} features, {ds.n_classes} classes")

    # 2. uHD: deterministic Sobol encoding, position-free, single training pass
    cfg = HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=4096)
    model = HDCModel.create(cfg, device=dev).fit(ds.train_images, ds.train_labels)
    acc = model.evaluate(ds.test_images, ds.test_labels)
    print(f"uHD  @ i=1 (one pass):      accuracy = {acc:.4f}")

    # 3. the baseline the paper compares against: pseudo-random P x L encoding,
    #    which needs iterative re-draws to find good vectors
    accs = baseline_iterative_search(cfg, ds.train_images, ds.train_labels,
                                     ds.test_images, ds.test_labels, iterations=3, device=dev)
    print(f"baseline over 3 draws:      avg = {sum(accs)/len(accs):.4f}  "
          f"(min {min(accs):.4f}, max {max(accs):.4f})")
    print("uHD >= baseline average:", acc >= sum(accs) / len(accs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
