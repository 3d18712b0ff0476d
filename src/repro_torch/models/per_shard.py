"""The recurrent mixers on each rank's shards (one process a card).

Where a block's input is a ``DTensor``, the RG-LRU, mLSTM and sLSTM
mixers run their plain code on this rank's local tensors, as
``attention._per_shard`` does for attention and ``moe._moe_ffn_exchange``
for the experts:

* x is laid out over the batch axes and whole on every other dim, and the
  rank takes its batch shard;
* the mixer's ``n`` channels (RG-LRU) or heads (xLSTM) are split over
  ``model`` where they divide it, each leaf gathered whole but for its
  block of them on ``model`` (``dims`` names that dim of each leaf, None
  for a leaf taken whole); where they do not divide it every rank
  computes all of them, as GSPMD keeps a dimension whole on ``model``
  where JAX's ``constrain`` drops the axis;
* the recurrences are per channel or per head, so no collective runs
  inside them (a ``DTensor`` dispatch a timestep would multiply the
  sLSTM's host cost by the sequence length);
* the weights keep the rules' layout on ``model`` wherever it is the
  block's, so that what moves between ranks is activations: a product
  that contracts over the split dim gives partial sums over ``model``, and
  the mixer's output is all-reduced (:meth:`Shards.out`), the RG-LRU's
  gate pre-activations and the mLSTM's output gate are reduce-scattered
  to the rank's block (:meth:`Shards.sum_scatter`), and the mLSTM's
  ``inner`` activations are all-gathered for its q, k, v and gates, which
  contract over all of them (:meth:`Shards.gather`);
* the decode states are taken and handed back in the same layout
  (batch over the batch axes, the block's dim on ``model``), which is
  ``transformer.decode_state_axes``' wherever the block splits.

Partial sums are reduced in float32 and rounded to the compute dtype once,
as the one-device product rounds its float32 accumulation once (a
bf16 reduction over the ranks would round at each step of it).

The gradients' placements are stated where each local tensor is taken:
a leaf's local gradient is partial over the batch axes that split x, and
over ``model`` where the rank used a whole leaf for its own block only;
x's is partial over ``model`` where the block splits.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (
    PartitionSpec as P, constrain, contiguous_stride, local_shard)


class Shards:
    """The per-shard layout of one block whose input `x` (a ``DTensor``)
    has `n` channels or heads to split over ``model``."""

    def __init__(self, x: torch.Tensor, n: int):
        self.dm = x.device_mesh
        self.names = tuple(self.dm.mesh_dim_names)
        self.m = dict(zip(self.names, self.dm.shape)).get("model", 1)
        self.split = self.m > 1 and n % self.m == 0
        self.x_whole = constrain(x, P(("pod", "data"), *([None] * (x.ndim - 1))))
        self.x_pl = tuple(self.x_whole.placements)

    def _pl(self, on_model) -> list:
        """x's placements with `on_model` on ``model``."""
        return [on_model if n == "model" else p for n, p in zip(self.names, self.x_pl)]

    def _block(self, dim: int | None) -> list:
        """Placements whole but for `dim` on ``model`` where the block splits."""
        from torch.distributed.tensor import Replicate, Shard

        return [Shard(dim) if n == "model" and self.split and dim is not None else Replicate()
                for n in self.names]

    @property
    def x(self) -> torch.Tensor:
        """This rank's batch shard of x, whole on every other dim."""
        from torch.distributed.tensor import Partial

        return local_shard(self.x_whole, self._pl(Partial()) if self.split else None)

    def weights(self, p: dict, dims: dict[str, int | None]) -> dict:
        """This rank's block of each leaf of `p` (gathered from the rules'
        layout)."""
        from torch.distributed.tensor import Partial

        out = {}
        for k, w in p.items():
            pl = self._block(dims[k])
            grad = [q if q.is_shard() else Partial()
                    if xp.is_shard() or (n == "model" and self.split) else q
                    for n, q, xp in zip(self.names, pl, self.x_pl)]
            out[k] = local_shard(w.redistribute(self.dm, pl), grad)
        return out

    def _state_pl(self, dim: int) -> list:
        from torch.distributed.tensor import Shard

        return self._pl(Shard(dim)) if self.split else list(self.x_pl)

    def states(self, state: dict | None, dims: dict[str, int]) -> dict | None:
        """The local tensors of a decode state (no gradient: serving)."""
        if state is None:
            return None
        return {k: v.redistribute(self.dm, self._state_pl(dims[k])).to_local()
                for k, v in state.items()}

    def new_states(self, state: dict | None, dims: dict[str, int]) -> dict | None:
        """The local states a block returned, as ``DTensor``s."""
        if state is None:
            return None
        from torch.distributed.tensor import DTensor

        out = {}
        for k, v in state.items():
            shape = [self.x_whole.shape[0], *v.shape[1:]]
            if self.split:
                shape[dims[k]] *= self.m
            out[k] = DTensor.from_local(v.contiguous(), self.dm, self._state_pl(dims[k]),
                                        run_check=False, shape=torch.Size(shape),
                                        stride=contiguous_stride(shape))
        return out

    def sum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's block of the last dim of the sum over ``model`` of
        the partial sums `t` (a reduce-scatter; its backward gathers)."""
        if not self.split:
            return t
        from torch.distributed.tensor import DTensor, Partial, Shard

        shape = [self.x_whole.shape[0], *t.shape[1:]]
        part = DTensor.from_local(t.float(), self.dm, self._pl(Partial()), run_check=False,
                                  shape=torch.Size(shape), stride=contiguous_stride(shape))
        return part.redistribute(self.dm, self._pl(Shard(t.ndim - 1))).to_local().to(t.dtype)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole last dim of `t`, of which this rank holds its block (an
        all-gather over ``model``; the rank's use of the whole is a partial
        gradient, reduce-scattered back to the blocks)."""
        if not self.split:
            return t
        from torch.distributed.tensor import DTensor, Partial, Shard

        shape = [self.x_whole.shape[0], *t.shape[1:-1], t.shape[-1] * self.m]
        block = DTensor.from_local(t, self.dm, self._pl(Shard(t.ndim - 1)), run_check=False,
                                   shape=torch.Size(shape), stride=contiguous_stride(shape))
        return local_shard(block.redistribute(self.dm, self.x_pl), self._pl(Partial()))

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """The block's output (B, T, D) laid out as x: the ranks' partial
        sums all-reduced over ``model`` where the block splits."""
        from torch.distributed.tensor import DTensor, Partial

        shape = self.x_whole.shape
        if not self.split:
            return DTensor.from_local(y, self.dm, self.x_pl, run_check=False, shape=shape,
                                      stride=contiguous_stride(shape))
        part = DTensor.from_local(y.float(), self.dm, self._pl(Partial()), run_check=False,
                                  shape=shape, stride=contiguous_stride(shape))
        return part.redistribute(self.dm, self.x_pl).to(y.dtype)
