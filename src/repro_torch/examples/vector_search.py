"""Vector search: the uHD store as an associative memory.

Classification is the k=1 special case of retrieval: the packed class
words are just a tiny item memory.  This example runs the same top-k
primitive at both scales:

  1. `search_packed` over a trained model's class words: k=1 recovers
     `predict`'s labels, k=3 adds runner-up classes with exact Hamming
     distances (a free confidence signal);
  2. `ItemMemory`: a growable store of packed hypervectors with
     add/delete/search: nearest-neighbor lookup and dedup over many
     thousands of rows, the same XOR+popcount scan, the same pinned
     (distance, index) order.

    PYTHONPATH=src python -m repro_torch.examples.vector_search              # on the card
    PYTHONPATH=src python -m repro_torch.examples.vector_search --device cpu

The port of ``examples/vector_search.py``, with its sizes and printed
lines.  On a card the scans run the hand-written top-k kernel
(``hamming_topk``), on the CPU its plain version.  The server's
``POST /v1/models/{name}:search`` serves the same primitive
(`repro_torch.examples.serve_http` sets one up).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core import HDCConfig, HDCModel, ItemMemory, resolve_device, search_packed
    from repro_torch.data import load_dataset

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # 1. classify-as-search: the class words are a C-row item memory -----------
    ds = load_dataset("mnist", n_train=2048, n_test=64)
    cfg = HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=4096)
    model = HDCModel.create(cfg, device=dev).fit(ds.train_images, ds.train_labels)
    class_words = model.pack()  # the pack-once serving artifact

    queries = ds.test_images[:8]
    labels = model.predict(queries).cpu().numpy()
    indices, distances = search_packed(model, queries, class_words, k=3)
    indices, distances = indices.cpu().numpy(), distances.cpu().numpy()
    assert (indices[:, 0] == labels).all()  # k=1 IS predict

    print("query  label  top-3 classes  hamming distances  margin")
    for i in range(len(queries)):
        margin = distances[i, 1] - distances[i, 0]
        print(f"  {i}      {labels[i]}     {indices[i].tolist()}      "
              f"{distances[i].tolist()}      {margin}")

    # 2. ItemMemory: the same scan over a big mutable store --------------------
    d = 1024
    memory = ItemMemory(d, device=dev)
    items = np.sign(rng.standard_normal((5000, d))).astype(np.float32)
    memory.add(items)
    print(f"\nitem memory: {len(memory)} rows, {memory.nbytes / 1024:.0f} KiB "
          f"packed ({d} dims -> {memory.n_words} words/row)")

    # exact self-retrieval: every stored row is its own nearest neighbor
    idx, dist = memory.search(items[:4], k=2)
    assert (idx[:, 0] == np.arange(4)).all() and (dist[:, 0] == 0).all()
    print("self-lookup:", idx[:, 0].tolist(), "at distance", dist[:, 0].tolist())

    # near-duplicate detection: flip 1% of one row's dims and search for it
    noisy = items[7].copy()
    flips = rng.choice(d, d // 100, replace=False)
    noisy[flips] = -noisy[flips]
    idx, dist = memory.search(noisy[None], k=3)
    print(f"1%-noisy copy of row 7 -> nearest rows {idx[0].tolist()} "
          f"at distances {dist[0].tolist()}")
    assert idx[0, 0] == 7 and dist[0, 0] == d // 100

    # delete shifts positions: rows after the deleted one move left
    memory.delete([0, 1, 2])
    idx, _ = memory.search(items[7][None], k=1)
    print(f"after deleting rows 0-2, old row 7 is found at position {idx[0, 0]}")
    assert idx[0, 0] == 4
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
