"""`ServingEngine`: the pack-once packed-Hamming inference unit.

The torch counterpart of ``repro.serving.engine``.  At load the engine
restores an `HDCModel`, places it per its execution backend (one
device, or D-sharded over a mesh: :mod:`repro_torch.serving.execution`),
and binarizes and packs the (C, D) class sums into words once, in the
backend's layout; after that every request batch is encode -> pack ->
XOR + popcount -> nearest class.  Engines are immutable: a reload builds
a new engine from a newer step.

Where every shard of the engine lies on one CUDA device (a
``DeviceExecution`` on a card, or a ``ShardedExecution`` whose shards
all name that card), the step at the static shape ``(batch_size,
n_features)`` is a CUDA graph: the counterpart of the JAX engine's one
jitted predict compiled per static shape.  :meth:`ServingEngine.warmup`
captures the ``predict`` graph; a ``search`` graph is captured for each
k at its first call.  A graph holds the copy of the batch from a pinned
staging buffer (:attr:`ServingEngine.staging`) into a static device
input, every op and kernel launch of the step, and the copy of the
results into pinned host buffers.  Other batch sizes run the step
eagerly, as a new shape retraces in JAX; so does every step on the CPU
(which has no graphs) and on a mesh over several cards.  A capture that
fails raises: there is no fallback to the eager step.

Every step, eager or replayed, runs on the engine's own streams, never
a card's default stream: one `torch.cuda.Stream` on each card that the
placed model's shards lie on (:attr:`ServingEngine.streams`), the output
card's being :attr:`ServingEngine.stream`.  Each waits at construction
on the constructing thread's current stream of its card, where the
model was placed and its words packed, and a step makes all of them
current, so a shard's encode and score on another card, and every
copy between cards, run on engine streams (a copy between two cards
orders the current streams of both).  The step is waited on with an
event of the output stream, recorded after the partials are summed
there, never with a device-wide synchronise: a hot reload captures the
new engine's graph on the caller's thread while the drain thread still
serves the old engine, and work on the default stream or a device-wide
wait from either thread would break that capture.  One step runs at a
time on an engine.
"""

from __future__ import annotations

import contextlib
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.hdc_model import HDCModel
from repro_torch.kernels import ops
from repro_torch.obs.profiler import span
from repro_torch.serving.execution import DeviceExecution, ShardedExecution, resolve_impl

__all__ = ["OP_PREDICT", "ServingEngine", "resolve_impl"]

#: The step tags: ("predict", 0) resolves to labels, ("search", k) to the
#: k nearest rows; each tag is one graph of an engine.
OP_PREDICT = ("predict", 0)


def _card(dev: torch.device) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def _stream_devices(model) -> list[torch.device]:
    """The distinct cards a placed model's shards lie on, the output
    device first: the engine owns a stream on each.  Empty on the CPU."""
    shards = getattr(model, "shards", None)
    devs = [model.device] + ([sh.device for sh in shards] if shards is not None else [])
    cards = [_card(d) for d in devs if d.type == "cuda"]
    return list(dict.fromkeys(cards))


def _graph_device(model) -> torch.device | None:
    """The one CUDA device every shard of a placed model lies on, or None
    (the CPU, or a mesh over several cards: those run eagerly)."""
    cards = _stream_devices(model)
    return cards[0] if len(cards) == 1 else None


class _Graph:
    """One captured step: the graph, its pinned host outputs, the kernel
    launches each replay runs, and the cached operands it reads."""

    __slots__ = ("graph", "outputs", "launches", "operands")

    def __init__(self, graph, outputs, launches, operands):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.operands = operands


class ServingEngine:
    """One loaded model, packed for inference, on one device or a mesh."""

    def __init__(
        self,
        model: HDCModel,
        *,
        batch_size: int = 64,
        step: int | None = None,
        source: str | Path | None = None,
        execution: DeviceExecution | ShardedExecution | None = None,
        device: torch.device | str | None = None,
    ):
        self.execution = execution or DeviceExecution(device=device)
        self.model = self.execution.place(model)
        self.batch_size = int(batch_size)
        self.impl = self.execution.impl
        self.step = step
        self.source = Path(source) if source is not None else None
        # pack ONCE at load: per-request work never touches the class sums
        self.class_words = self.execution.pack(self.model)
        out = self.model.device
        self._graph_device = _graph_device(self.model)
        #: one stream a card of the placed model, the output card's first
        self.streams = [torch.cuda.Stream(device=dev) for dev in _stream_devices(self.model)]
        for s in self.streams:
            # the model and its words were made on the loading thread's streams
            s.wait_stream(torch.cuda.current_stream(s.device))
        self.stream = self.streams[0] if self.streams else None
        self._lock = threading.RLock()
        shape = (self.batch_size, self.model.cfg.n_features)
        self._staging = torch.zeros(shape, dtype=torch.float32, pin_memory=out.type == "cuda")
        #: (batch_size, n_features) float32 rows, pinned on a card: the batch
        #: a step reads, written by the batcher inside :meth:`staged`
        self.staging = self._staging.numpy()
        self._input: torch.Tensor | None = None  # the graphs' static device input
        self._pool = None
        self._graphs: dict[tuple[str, int], _Graph] = {}
        self._done = torch.cuda.Event() if self.stream is not None else None
        self.n_replays = 0  # steps served by a graph replay

    @classmethod
    def from_checkpoint(
        cls,
        path: str | Path,
        *,
        step: int | None = None,
        batch_size: int = 64,
        execution: DeviceExecution | ShardedExecution | None = None,
        device: torch.device | str | None = None,
    ) -> "ServingEngine":
        """Load a checkpointed `HDCModel` (latest step by default; gathered
        or per-host shards), place it per `execution` and pack it."""
        from repro_torch.checkpoint.manager import CheckpointManager

        execution = execution or DeviceExecution(device=device)
        if step is None:
            step = CheckpointManager(path).latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
        model = execution.load(path, step)
        return cls(model, batch_size=batch_size, step=step, source=path, execution=execution)

    # -- inference --------------------------------------------------------

    def predict(self, images) -> np.ndarray:
        """(B, H) raw images -> (B,) int32 labels (host numpy)."""
        return self._run(OP_PREDICT, images)

    def search(self, images, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(B, H) raw images -> ((B, k) int32 row indices, (B, k) int32
        Hamming distances), ascending by (distance, index); ``k=1``
        indices equal `predict`'s labels."""
        return self._run(("search", int(k)), images)

    @contextlib.contextmanager
    def staged(self):
        """Hold the engine for one step and yield :attr:`staging`: write the
        batch into it, then pass it to `predict` or `search`, which read
        it in place."""
        self._acquire()
        try:
            yield self.staging
        finally:
            self._lock.release()

    def warmup(self) -> "ServingEngine":
        """Prepare the static-shape predict before taking traffic: capture
        its CUDA graph (two eager steps first build the kernels and the
        cached operands), or, where the engine has no graph, run one
        eager step."""
        with self._lock:
            if self._graph_device is not None:
                self._graph(OP_PREDICT)
            else:
                self._eager(OP_PREDICT, self._staging)
        return self

    def _acquire(self) -> None:
        """Take the engine's lock; where another thread holds it, the wait
        is the span ``engine.lock``."""
        if not self._lock.acquire(blocking=False):
            with span("engine.lock"):
                self._lock.acquire()

    def _run(self, op: tuple[str, int], images):
        self._acquire()
        try:
            if self._graph_device is None or len(images) != self.batch_size:
                return self._eager(op, images)
            if images is not self.staging:
                with span("engine.stage"):
                    x = torch.as_tensor(images)
                    if x.shape != self._staging.shape:
                        raise ValueError(f"expected ({self.batch_size}, n_features) images, "
                                         f"got {tuple(x.shape)}")
                    self._staging.copy_(x)
            return self._replay(self._graph(op))
        finally:
            self._lock.release()

    def _step(self, op: tuple[str, int], images) -> tuple[torch.Tensor, ...]:
        if op[0] == "search":
            return self.execution.search(self.model, self.class_words, images, op[1])
        return (self.execution.predict(self.model, self.class_words, images),)

    def _on_stream(self) -> contextlib.ExitStack:
        """Make every engine stream current on its card, the output card's
        last, so that the output card is also the current device."""
        stack = contextlib.ExitStack()
        for s in reversed(self.streams):
            stack.enter_context(torch.cuda.stream(s))
        return stack

    def _eager(self, op: tuple[str, int], images):
        with self._on_stream():
            step = self._step(op, images)
            with span("engine.copy_out"):
                out = tuple(t.cpu().numpy() for t in step)
        return out if op[0] == "search" else out[0]

    def _graph(self, op: tuple[str, int]) -> _Graph:
        g = self._graphs.get(op)
        if g is None:
            g = self._graphs[op] = self._capture(op)
        return g

    def _capture(self, op: tuple[str, int]) -> _Graph:
        """Two eager steps on the engine's stream, then one capture of the
        step at the static shape; raises if the capture fails."""
        dev = self._graph_device
        rows = (self.batch_size, op[1]) if op[0] == "search" else (self.batch_size,)
        outputs = tuple(torch.empty(rows, dtype=torch.int32, pin_memory=True)
                        for _ in range(2 if op[0] == "search" else 1))
        with torch.cuda.device(dev), self._on_stream():
            if self._input is None:
                self._input = torch.empty(self._staging.shape, dtype=torch.float32, device=dev)
                self._pool = torch.cuda.graph_pool_handle()
            for _ in range(2):
                self._input.copy_(self._staging, non_blocking=True)
                self._step(op, self._input)
            self.stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            with ops.recording() as launches, encoding.BASELINE_OPERANDS.holding() as operands:
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    self._input.copy_(self._staging, non_blocking=True)
                    for host, t in zip(outputs, self._step(op, self._input)):
                        host.copy_(t, non_blocking=True)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()  # ends the failed capture; its error is the one above
                    raise
                graph.capture_end()
        return _Graph(graph, outputs, launches, operands)

    def _replay(self, g: _Graph):
        with span("engine.replay"), self._on_stream():
            g.graph.replay()
            self._done.record(self.stream)
        with span("engine.wait"):
            self._done.synchronize()
        self.n_replays += 1
        with span("engine.copy_out"):
            ops.add_launches(g.launches)
            out = tuple(t.numpy().copy() for t in g.outputs)
        return out if len(out) == 2 else out[0]

    def describe(self) -> dict:
        cfg = self.model.cfg
        words = self.class_words
        words = words if isinstance(words, list) else [words]
        return {
            "encoder": cfg.encoder,
            "d": cfg.d,
            "n_classes": cfg.n_classes,
            "impl": self.impl,
            "placement": self.execution.placement,
            "execution": self.execution.describe(),
            "batch_size": self.batch_size,
            "step": self.step,
            "source": str(self.source) if self.source else None,
            "n_seen": self.model.n_examples,
            "packed_bytes": 4 * sum(w.numel() for w in words),
            "codebook_bytes": int(self.model.codebook_bytes),
            "graph": self._graph_device is not None,
            "n_replays": self.n_replays,
            "graphs": [
                {"op": op[0], "k": op[1], "shape": [self.batch_size, cfg.n_features]}
                for op in list(self._graphs)
            ],
        }
