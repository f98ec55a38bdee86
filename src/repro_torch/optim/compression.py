"""Gradient compression with error feedback: the collective-free half.

Port of the parts of ``repro.optim.compression`` that run outside any
collective: the int8 block quantization of a flat vector, the f32
error-feedback state, the downcast with its loss, and the gradient
buckets (``BucketSpec``, ``make_bucket_spec``, ``bucketize``,
``unbucketize``, ``init_grad_sync_state``).  One bucket is the payload
of one ``host_plan("quantized_allreduce", ...)`` call.

Error-feedback convention, as in the reference: error leaves are f32
and live in SUM units -- each rank keeps exactly the quantization error
it generated, so ``exact_sum == lossy_sum + sum_over_ranks(err)`` holds
to f32 rounding, and feeding ``g + err`` into the next allreduce
restores the lost mass.

Pytrees are flattened in the reference's order
(:mod:`repro_torch.core.tree`): bucket assignment follows the flatten
order, which sorts a plain dict's keys as ``jax.tree`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.comm import resolve_device
from ..core.tree import tree_flatten, tree_unflatten
from ..kernels.quant_ops import (
    QBLOCK,
    block_nonfinite,
    dequant_blocks,
    quant_blocks,
)

#: Quantization block length (elements sharing one f32 scale).
BLOCK = QBLOCK

__all__ = [
    "BLOCK",
    "quantize_int8",
    "dequantize_int8",
    "block_nonfinite",
    "init_error_state",
    "BucketSpec",
    "make_bucket_spec",
    "bucketize",
    "unbucketize",
    "init_grad_sync_state",
]


def _numel(leaf) -> int:
    return int(np.prod(tuple(leaf.shape))) if len(leaf.shape) else 1


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of a [N] f32 vector
    (N % BLOCK == 0) -> (q [nb, BLOCK] int8, scale [nb, 1] f32); a block
    holding a NaN/inf gets a NaN scale (see :func:`block_nonfinite`)."""
    return quant_blocks(x.reshape(-1, BLOCK))


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` -> flat [N] f32 (flagged blocks
    dequantize to all-NaN)."""
    return dequant_blocks(q, scale).reshape(-1)


def init_error_state(params):
    """Zero error-feedback state: f32 leaves of each param's shape, on
    its device, whatever the gradient dtype (bf16/f16 error state would
    quantize the feedback itself away)."""
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        torch.zeros(tuple(p.shape), dtype=torch.float32,
                    device=p.device if isinstance(p, torch.Tensor) else None)
        for p in leaves])


def _cast_with_delta(red: torch.Tensor, dtype) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Downcast the f32 mean to the gradient dtype -> ``(cast, delta)``,
    ``delta`` the per-element f32 loss (0 for f32, and 0 where it is not
    finite, like the quantization error)."""
    cast = red.to(dtype)
    if dtype == torch.float32:
        return cast, torch.zeros_like(red)
    delta = red - cast.float()
    return cast, torch.where(torch.isfinite(delta), delta,
                             torch.zeros_like(delta))


# ----------------------------------------------------- gradient buckets


@dataclass(frozen=True)
class BucketSpec:
    """Frozen leaf->bucket assignment for a parameter tree (hashable, so
    it can key plan caches).  ``assignment[i]`` is the bucket of leaf i
    (flatten order), ``offsets[i]`` its element offset inside that
    bucket, ``bucket_sizes[b]`` the total f32 elements of bucket b."""

    leaf_sizes: Tuple[int, ...]
    assignment: Tuple[int, ...]
    offsets: Tuple[int, ...]
    bucket_sizes: Tuple[int, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)


def make_bucket_spec(params, bucket_bytes: int = 4 << 20) -> BucketSpec:
    """Greedy bucketization of a tree's leaves in flatten order.

    Leaves are anything with a ``.shape`` (tensors, meta tensors, numpy
    arrays).  Buckets fill to ~``bucket_bytes`` of f32 payload (4 bytes
    an element); a leaf larger than the budget gets its own bucket.
    """
    leaves, _ = tree_flatten(params)
    if not leaves:
        raise ValueError("params tree has no array leaves")
    budget = max(1, int(bucket_bytes) // 4)
    sizes, assignment, offsets, bucket_sizes = [], [], [], []
    cur = 0
    for leaf in leaves:
        n = _numel(leaf)
        if bucket_sizes and cur + n > budget and cur > 0:
            bucket_sizes[-1] = cur
            bucket_sizes.append(0)
            cur = 0
        if not bucket_sizes:
            bucket_sizes.append(0)
        assignment.append(len(bucket_sizes) - 1)
        offsets.append(cur)
        sizes.append(n)
        cur += n
    bucket_sizes[-1] = cur
    return BucketSpec(leaf_sizes=tuple(sizes), assignment=tuple(assignment),
                      offsets=tuple(offsets),
                      bucket_sizes=tuple(bucket_sizes))


def bucketize(tree, spec: BucketSpec) -> List[torch.Tensor]:
    """Flatten a tree of tensors into ``spec``'s f32 bucket vectors."""
    leaves, _ = tree_flatten(tree)
    if len(leaves) != len(spec.leaf_sizes):
        raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                         f"{len(spec.leaf_sizes)}")
    parts: List[List[torch.Tensor]] = [[] for _ in spec.bucket_sizes]
    for leaf, b in zip(leaves, spec.assignment):
        parts[b].append(leaf.to(torch.float32).reshape(-1))
    out = []
    for b, chunk in enumerate(parts):
        v = torch.cat(chunk) if len(chunk) > 1 else chunk[0]
        if v.shape[0] != spec.bucket_sizes[b]:
            raise ValueError(f"bucket {b} has {v.shape[0]} elements, "
                             f"spec expects {spec.bucket_sizes[b]}")
        out.append(v)
    return out


def unbucketize(flats: Sequence[torch.Tensor], spec: BucketSpec, like):
    """Inverse of :func:`bucketize`: slice bucket vectors back into a
    tree shaped (and typed) like ``like`` -> ``(tree, deltas)``, where
    ``deltas`` are per-bucket f32 downcast-loss vectors (zero for f32
    leaves) for the error-feedback accounting."""
    leaves, treedef = tree_flatten(like)
    outs = []
    deltas = [torch.zeros((s,), dtype=torch.float32, device=f.device)
              for s, f in zip(spec.bucket_sizes, flats)]
    for leaf, b, off, n in zip(leaves, spec.assignment, spec.offsets,
                               spec.leaf_sizes):
        cast, delta = _cast_with_delta(flats[b][off:off + n], leaf.dtype)
        outs.append(cast.reshape(tuple(leaf.shape)))
        deltas[b][off:off + n] = delta
    return tree_unflatten(treedef, outs), deltas


def init_grad_sync_state(spec: BucketSpec, dp: int = 1, *,
                         device: Union[str, torch.device, None] = None):
    """Zero error-feedback buckets: a tuple of [dp, bucket_size] f32
    tensors, one row per data-parallel rank.  ``device=None`` means
    ``"cuda"`` and raises with no card."""
    dev = resolve_device(device)
    return tuple(torch.zeros((dp, s), dtype=torch.float32, device=dev)
                 for s in spec.bucket_sizes)
