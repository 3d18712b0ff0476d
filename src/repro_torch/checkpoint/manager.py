"""Atomic checkpoints in the JAX package's on-disk layout.

One directory per step, as ``repro.checkpoint.manager`` writes it::

    <root>/step_000123/
        manifest.json       # leaves (key, file, shape, dtype), step, extra
        leaf_000000.npy ... # one .npy per leaf, in sorted-key order
    <root>/step_000123.tmp/ # staging dir, renamed when complete

A tree is a nested dict of numpy arrays (or tensors, copied to the
host); leaf keys join the dict keys with "/" (``codebooks/direction``).
Either package restores the other's checkpoints.  Writes go to ``.tmp``
and are renamed only when complete, and the ``keep_n`` newest steps are
kept on every publish.

Per-host shards, in the same layout: ``save_shard`` writes one host's
slices of the sharded leaves as ``leaf_XXXXXX.sNNN.npy`` (the manifest,
written by host 0, gives such a leaf ``file`` = the stem, ``shards`` and
``axis``); ``finalize_shards`` publishes once every file is there, and
``restore`` concatenates the slices along ``axis``.  Either package
restores the other's sharded checkpoints too.
"""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's order: dict keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(pairs: list[tuple[str, Any]]) -> dict:
    out: dict = {}
    for key, leaf in pairs:
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def _shard_files(meta: dict) -> list[str]:
    """The per-host files of a sharded leaf's manifest entry."""
    return [f"{meta['file']}.s{i:03d}.npy" for i in range(meta["shards"])]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, root: str | Path, keep_n: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n

    # -- write -----------------------------------------------------------

    def save(self, step: int, tree: Tree, *, extra: dict | None = None) -> None:
        """Checkpoint `tree` at `step` atomically, then prune old steps."""
        final = self.root / f"step_{step:09d}"
        tmp = self.root / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": [], "extra": extra or {}, "time": time.time()}
        for i, (key, leaf) in enumerate(_flatten(tree)):
            arr = _host(leaf)
            fname = f"leaf_{i:06d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            )
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()

    def save_shard(
        self, step: int, tree: Tree, *, process_index: int, process_count: int,
        shard_axes: dict[str, int], extra: dict | None = None,
    ) -> None:
        """Stage host `process_index`'s part of a sharded checkpoint.

        `tree` is the host's local view: the leaves named in `shard_axes`
        (key -> sharded axis) hold its slice and go to
        ``leaf_XXXXXX.s{process_index:03d}.npy``; the other leaves are
        replicated and written by host 0 alone, which also writes the
        manifest.  Files stay in the step's ``.tmp`` staging directory
        until :meth:`finalize_shards`.  Host 0's call first clears an
        aborted attempt's staging (:meth:`begin_shards`), so host 0
        writes first: stale shard files can then never complete a later
        attempt."""
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        tmp = self.root / f"step_{step:09d}.tmp"
        if process_index == 0:
            self.begin_shards(step)
        else:
            tmp.mkdir(parents=True, exist_ok=True)
        flat = _flatten(tree)
        unknown = set(shard_axes) - {k for k, _ in flat}
        if unknown:
            raise KeyError(f"shard_axes names unknown leaves: {sorted(unknown)}")
        manifest = {
            "step": step, "leaves": [], "extra": extra or {}, "time": time.time(),
            "process_count": process_count,
        }
        for i, (key, leaf) in enumerate(flat):
            sharded = key in shard_axes
            if not sharded and process_index != 0:
                continue  # a replicated leaf: host 0 writes it
            arr = _host(leaf)
            name = f"leaf_{i:06d}.s{process_index:03d}.npy" if sharded else f"leaf_{i:06d}.npy"
            np.save(tmp / name, arr)
            meta = {"key": key, "file": f"leaf_{i:06d}.npy", "shape": list(arr.shape),
                    "dtype": str(arr.dtype)}
            if sharded:
                meta.update(file=f"leaf_{i:06d}", shards=process_count, axis=int(shard_axes[key]))
            manifest["leaves"].append(meta)
        if process_index == 0:
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
                f.flush()

    def begin_shards(self, step: int) -> None:
        """Start a sharded save attempt: clear the staging directory an
        aborted earlier attempt may have left."""
        tmp = self.root / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

    def finalize_shards(self, step: int) -> None:
        """Publish a sharded save atomically once every file its staged
        manifest lists is there; a missing file (a host that has not
        written) raises and publishes nothing."""
        tmp = self.root / f"step_{step:09d}.tmp"
        manifest_path = tmp / "manifest.json"
        if not manifest_path.exists():
            raise FileNotFoundError(
                f"no staged manifest for step {step} under {tmp} "
                "(host 0 has not called save_shard yet)"
            )
        missing = []
        for m in json.loads(manifest_path.read_text())["leaves"]:
            if "shards" in m:
                missing += [f for f in _shard_files(m) if not (tmp / f).exists()]
            elif not (tmp / m["file"]).exists():
                missing.append(m["file"])
        if missing:
            raise FileNotFoundError(
                f"step {step} is missing shard files {missing[:8]}: every host must "
                "save_shard before finalize_shards publishes"
            )
        final = self.root / f"step_{step:09d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        """Keep the `keep_n` newest finalized steps (0 keeps all) and drop
        `.tmp` staging debris older than the oldest kept step.  A live
        sharded save stages at a step at or after the latest published
        one, so it is never collected."""
        if not self.keep_n:
            return
        steps = self.all_steps()
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)
        kept = steps[-self.keep_n :]
        if not kept:
            return
        for p in self.root.iterdir():
            m = re.fullmatch(r"step_(\d+)\.tmp", p.name)
            if m and int(m.group(1)) < kept[0]:
                shutil.rmtree(p, ignore_errors=True)

    # -- read ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.root.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def poll_latest(self, after: int | None = None) -> int | None:
        """Newest complete step strictly newer than `after`, else None.

        The hot-reload poll: serving watches a checkpoint directory and
        swaps engines only when the trainer has published (atomically
        renamed) a step it has not loaded yet.  `after=None` degrades to
        `latest_step`.
        """
        latest = self.latest_step()
        if latest is None or (after is not None and latest <= after):
            return None
        return latest

    def _manifest(self, step: int) -> dict:
        return json.loads((self.root / f"step_{step:09d}" / "manifest.json").read_text())

    def restore(self, step: int, like: Tree) -> Tree:
        """Numpy leaves of `step` in the structure of `like`, whose leaves
        are shapes (tuples) or arrays; shapes are checked."""
        d = self.root / f"step_{step:09d}"
        by_key = {m["key"]: m for m in self._manifest(step)["leaves"]}
        pairs = []
        for key, leaf in _flatten(like):
            meta = by_key.get(key)
            if meta is None:
                raise KeyError(f"checkpoint {step} missing leaf {key!r}")
            if meta.get("shards"):  # stitch the per-host slices
                arr = np.concatenate([np.load(d / f) for f in _shard_files(meta)],
                                     axis=meta["axis"])
            else:
                arr = np.load(d / meta["file"])
            want = tuple(leaf) if isinstance(leaf, tuple) else tuple(np.shape(leaf))
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != {want}")
            pairs.append((key, arr))
        return _unflatten(pairs)

    def extra(self, step: int) -> dict:
        return self._manifest(step).get("extra", {})

    def leaf_meta(self, step: int) -> dict[str, dict]:
        """Manifest metadata per flat leaf key (shape, dtype)."""
        return {m["key"]: m for m in self._manifest(step)["leaves"]}
