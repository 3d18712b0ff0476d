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

``save(..., blocking=False)`` copies the tree to host memory before it
returns (a clone on the CPU, a device-to-host copy from a card: the
training step updates its tensors in place, so a view would let the next
step into the checkpoint), then writes on a daemon thread; one save is in
flight at a time, and a write error surfaces at the next ``wait()``.
bfloat16 leaves are stored as JAX stores them: the bits as ``uint16``,
``"dtype": "bfloat16"`` in the manifest.  ``install_sigterm_handler``
flushes a final checkpoint on SIGTERM and exits 0 (the preemption
contract), holding the signal while a step updates state in place.

Under a process group (one process a card, the LM path on a mesh) the
tree's ``DTensor`` leaves are gathered whole (``full_tensor()``), every
rank taking part leaf by leaf in the same sorted-key order; rank 0 alone
copies each gathered leaf to host memory and writes, and the other ranks
free theirs at once (one host copy of the tree, on rank 0).  The files
are byte for byte those of a one-device save of the same tree.  A
non-blocking save gathers before it returns; a blocking save and
``wait()`` end on a barrier, so that every rank sees the published
step.  ``restore`` lays each leaf out as the matching leaf
of ``like`` (its ``DTensor`` placements).  The SIGTERM handler then
holds every signal to the end of the step and all-reduces the stop flag
there, so every rank saves and stops at the same step.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.tree import tree_unflatten

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


def _group():
    """The default process group's module, or None when no group is up."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank() -> int:
    dist = _group()
    return dist.get_rank() if dist else 0


def _whole(leaf):
    """`leaf`, or where it is a ``DTensor`` the whole tensor gathered from
    its shards (a collective every rank takes part in)."""
    return leaf.detach().full_tensor() if is_dtensor(leaf) else leaf


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of `leaf` that no later in-place update reaches, and its
    logical dtype; a bfloat16 tensor becomes its bits as uint16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _load(path: Path, dtype: str):
    arr = np.load(path)
    if dtype == "bfloat16":  # numpy has no bfloat16: the bits go to torch
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


class CheckpointManager:
    def __init__(self, root: str | Path, keep_n: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._unsynced = False  # a save under a group that no barrier has closed

    # -- write -----------------------------------------------------------

    def save(self, step: int, tree: Tree, *, blocking: bool = True,
             extra: dict | None = None) -> None:
        """Checkpoint `tree` at `step` atomically, then prune old steps.
        The tree is copied to host memory before this returns; with
        ``blocking=False`` the files are written on a background thread.
        Under a process group every rank calls this with its shards, and
        rank 0 writes."""
        self.wait()  # one in-flight save at a time
        writer = _rank() == 0
        host = []
        for key, leaf in _flatten(tree):
            whole = _whole(leaf)  # every rank gathers, leaf by leaf in the same order
            if writer:  # the others drop the gathered leaf at once: no host copy
                host.append((key, *_host(whole)))
            del whole
        self._unsynced = _group() is not None

        def write():
            try:
                if writer:
                    self._write(step, host, extra or {})
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Wait for the save in flight; raise its error, if it had one.
        Under a process group the ranks then meet at a barrier, so that
        the step rank 0 wrote is there for every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._unsynced:
            self._unsynced = False
            _group().barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: list[tuple[str, np.ndarray, str]], extra: dict) -> None:
        final = self.root / f"step_{step:09d}"
        tmp = self.root / f"step_{step:09d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": [], "extra": extra, "time": time.time()}
        for i, (key, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:06d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype}
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
            arr, dtype = _host(leaf)
            name = f"leaf_{i:06d}.s{process_index:03d}.npy" if sharded else f"leaf_{i:06d}.npy"
            np.save(tmp / name, arr)
            meta = {"key": key, "file": f"leaf_{i:06d}.npy", "shape": list(arr.shape),
                    "dtype": dtype}
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
        are shapes (tuples), arrays or tensors; shapes are checked.  A
        bfloat16 leaf comes back as a ``torch.bfloat16`` tensor, and where
        `like`'s leaf is a ``DTensor`` the leaf comes back laid out as it
        (each rank keeps its shards of the whole array it read)."""
        d = self.root / f"step_{step:09d}"
        by_key = {m["key"]: m for m in self._manifest(step)["leaves"]}
        leaves = []
        for key, leaf in _flatten(like):
            meta = by_key.get(key)
            if meta is None:
                raise KeyError(f"checkpoint {step} missing leaf {key!r}")
            if meta.get("shards"):  # stitch the per-host slices
                parts = [_load(d / f, meta["dtype"]) for f in _shard_files(meta)]
                cat = torch.cat if isinstance(parts[0], torch.Tensor) else np.concatenate
                arr = cat(parts, meta["axis"])
            else:
                arr = _load(d / meta["file"], meta["dtype"])
            want = tuple(leaf) if isinstance(leaf, tuple) else tuple(np.shape(leaf))
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != {want}")
            if is_dtensor(leaf):
                from torch.distributed.tensor import distribute_tensor

                local = torch.as_tensor(arr).to(leaf.to_local().device)
                arr = distribute_tensor(local, leaf.device_mesh, leaf.placements,
                                        src_data_rank=None)
            leaves.append(arr)
        return tree_unflatten(like, leaves)

    def extra(self, step: int) -> dict:
        return self._manifest(step).get("extra", {})

    def leaf_meta(self, step: int) -> dict[str, dict]:
        """Manifest metadata per flat leaf key (shape, dtype)."""
        return {m["key"]: m for m in self._manifest(step)["leaves"]}


class SigtermHandler:
    """SIGTERM -> ``save_fn()`` then ``SystemExit(0)``.  A SIGTERM that
    arrives inside :meth:`hold` is served when the block ends (not if it
    raises): the state the block updates in place is saved whole.

    Under a process group a SIGTERM is always served at the end of a
    :meth:`hold` block, after an all-reduce (max) of every rank's "stop"
    flag there: a rank that got no signal, or got it a step later, stops
    at the same step, and every rank takes part in the save's gathers."""

    def __init__(self, save_fn: Callable[[], None]):
        self.save_fn = save_fn
        self._held = False
        self._pending = False
        self._flushing = False
        self._previous = signal.signal(signal.SIGTERM, self._on_signal)

    def close(self) -> None:
        """Put back the SIGTERM handler this one replaced."""
        signal.signal(signal.SIGTERM, self._previous)

    def _on_signal(self, signum, frame) -> None:
        if self._flushing:
            return  # a second SIGTERM (torchrun forwards its own) during the save
        if self._held or _group() is not None:
            self._pending = True
            return
        self._flush()

    def _flush(self) -> None:
        self._flushing = True
        self.save_fn()
        raise SystemExit(0)

    def _stop_everywhere(self) -> bool:
        """The pending flag, all-reduced (max) over the group where one is up."""
        dist = _group()
        if dist is None:
            return self._pending
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        flag = torch.tensor([int(self._pending)], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    @contextlib.contextmanager
    def hold(self):
        self._held = True
        try:
            yield
        finally:
            self._held = False
        if self._stop_everywhere():
            self._flush()


def install_sigterm_handler(save_fn: Callable[[], None]) -> SigtermHandler:
    """Preemption hook: checkpoint then exit(0) on SIGTERM.  Python runs
    the handler in the main thread between two bytecodes; a loop that
    updates state in place runs each update inside the returned
    handler's ``hold()``."""
    return SigtermHandler(save_fn)
