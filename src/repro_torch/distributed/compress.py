"""Gradient compression for the cross-pod data-parallel reduction.

The torch counterpart of ``repro.distributed.compress``: int8
quantization with error feedback (1-bit-Adam family; Seide et al. 2014,
Karimireddy et al. 2019):

    v   = g + e                 (fold in the residual carried in opt state)
    s   = max|v| (per leaf)     (max across pods -> shared scale)
    q   = round(v / s * 127)    int8
    ghat= sum(q) / n_pods * s / 127
    e'  = v - dequant(q)        (local quantization error, fed back)

The hierarchical pattern: a full-precision mean over the intra-pod data
group first, then the compressed mean over the pod group.  JAX runs these
inside ``shard_map`` over mesh axes; here each process is one cell, and
the axes are ``torch.distributed`` process groups (``pod_data_groups``
builds them for a pods x data grid of ranks, rank = pod * n_data + data,
JAX's row-major order of a ("pod", "data") mesh).

The packed sign variant reuses the uHD bit packing (the paper's unary
bit-streams in the distributed-optimizer layer).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import unary
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


def quantize_int8(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v / scale * 127.0), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * (scale / 127.0)


def pod_data_groups(n_pods: int, n_data: int):
    """(pod group, data group) of this rank in a pods x data grid of
    ``dist.get_world_size() == n_pods * n_data`` ranks.  Every rank
    creates every group, in one order (``dist.new_group``'s contract)."""
    if dist.get_world_size() != n_pods * n_data:
        raise ValueError(f"{dist.get_world_size()} ranks for a {n_pods} x {n_data} grid")
    rank = dist.get_rank()
    pod_groups = [dist.new_group([p * n_data + d for p in range(n_pods)]) for d in range(n_data)]
    data_groups = [dist.new_group([p * n_data + d for d in range(n_data)]) for p in range(n_pods)]
    return pod_groups[rank % n_data], data_groups[rank // n_data]


def compressed_psum_leaf(v: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed mean over `group`.  Returns (mean_estimate, error)."""
    scale = torch.max(torch.abs(v)) + 1e-12
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = quantize_int8(v, scale)
    # v - dequantize_int8(q, scale), rounded once as XLA's fused
    # multiply-add rounds JAX's
    err = torch.addcmul(v, q.float(), scale / 127.0, value=-1)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    n = dist.get_world_size(group)
    mean = total.float() * (scale / 127.0) / float(n)
    return mean, err


def compressed_grad_sync(grads: Tree, errors: Tree, *, pod_group, data_group) -> tuple[Tree, Tree]:
    """Hierarchical gradient sync: full-precision mean over the data
    group, int8 error-feedback mean over the pod group.  Returns
    (synced_grads, new_errors); the inputs are left as they were."""

    def leaf(g, e):
        g = g.clone()
        dist.all_reduce(g, group=data_group)
        g = g / float(dist.get_world_size(data_group))
        return compressed_psum_leaf(g + e, pod_group)

    pairs = tree_map(leaf, grads, errors)
    return _split(pairs, 0), _split(pairs, 1)


def _split(pairs: Tree, i: int) -> Tree:
    return {k: _split(v, i) for k, v in pairs.items()} if isinstance(pairs, dict) else pairs[i]


def sign_compress_packed(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """1-bit (sign) compression with the uHD bit-packing machinery.

    Returns (packed signs, int32 bit patterns of JAX's uint32 words, of
    ceil(n/32) words; scale = mean|v|).  The majority vote of packed
    signs across workers is the paper's popcount-with-threshold circuit
    (``unary.majority_threshold``)."""
    flat = v.reshape(-1)
    scale = torch.mean(torch.abs(flat)) + 1e-12
    return unary.pack_bits(flat >= 0), scale


def sign_decompress_packed(packed: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    signs = unary.unpack_hypervector(packed, n).float()
    return (signs * scale).reshape(shape)


def init_error_state(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def bytes_saved(params: Tree) -> tuple[int, int]:
    """(uncompressed, compressed) payload bytes of one cross-pod sync."""
    leaves = tree_leaves(params)
    return sum(p.numel() * 4 for p in leaves), sum(p.numel() for p in leaves)
