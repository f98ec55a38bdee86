"""Gradient compression with error feedback.

Port of ``repro.optim.compression``.  Two int8-on-the-wire transports
implement the lossy mean-allreduce over a rank group
(:class:`~repro_torch.core.comm.StackedGroup` or
:class:`~repro_torch.core.comm.DistGroup`):

  * ``transport="circulant"`` (default): the quantized circulant
    allreduce of the communicator (``circulant_qallreduce``), int8
    blocks and per-block f32 scales on the wire, every requantization's
    error captured in the fused round step;
  * ``transport="ring"``: the ring reduce-scatter and all-gather
    (``2(p-1)`` hops), the baseline.

Where the reference runs inside ``shard_map`` over a mesh axis, these
functions take the group: every tensor leaf carries a leading axis over
``group.ranks`` (all p ranks on a ``StackedGroup``, the process's own
on a ``DistGroup``), row i being rank ``group.ranks[i]``'s.  The
gradient buckets (``BucketSpec``, ``make_bucket_spec``, ``bucketize``,
``unbucketize``, ``init_grad_sync_state``) group leaves so that one
bucket spec freezes one quantized-allreduce plan; ``compressed_grad_sync``
syncs a gradient after the backward, ``streamed_sync_params`` inside it
(an autograd marker a bucket).  On the card over a ``StackedGroup`` the
streamed sync of a bucket runs on a side stream of its own, overlapping
the backward of the buckets after it, and ``wait_streamed_sync`` joins
it once the backward returns; over a ``DistGroup`` it runs inline.

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
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.collectives import circulant_qallreduce
from ..core.comm import StackedGroup, get_comm, resolve_device, side_stream
from ..core.tree import tree_flatten, tree_unflatten
from ..kernels.quant_ops import (
    QBLOCK,
    block_nonfinite,
    dequant_blocks,
    fma_f32,
    quant_blocks,
    quant_error,
)

#: Quantization block length (elements sharing one f32 scale).
BLOCK = QBLOCK

__all__ = [
    "BLOCK",
    "quantize_int8",
    "dequantize_int8",
    "block_nonfinite",
    "init_error_state",
    "compressed_psum_ring",
    "compressed_allreduce_tree",
    "BucketSpec",
    "make_bucket_spec",
    "bucketize",
    "unbucketize",
    "init_grad_sync_state",
    "compressed_grad_sync",
    "streamed_sync_params",
    "wait_streamed_sync",
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


def inv(k: int) -> float:
    """The float32 reciprocal of ``k``.  A mean over k is taken by
    multiplying with it: the jitted reference divides by the constant k,
    and XLA strength-reduces that division into this multiplication."""
    return float(np.float32(1.0) / np.float32(k))


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


def compressed_psum_ring(flat: torch.Tensor, group):
    """int8 ring all-reduce (mean) of ``flat`` [len(group.ranks), m] f32,
    m a multiple of ``p * BLOCK`` (the caller pads).  Returns ``(mean,
    err)``, both [rows, m]: the mean, and each rank's own quantization
    error in sum units (every hop's requantization of the segment it
    ships, and the final quantize of the segment it owns)."""
    p = group.p
    if p == 1:
        return flat, torch.zeros_like(flat)
    lr, m = flat.shape
    dev = flat.device
    segs = flat.reshape(lr, p, m // p)
    rows = torch.arange(lr, device=dev)
    r = torch.arange(group.ranks.start, group.ranks.stop, device=dev)
    err = torch.zeros_like(segs)

    def quant(x):
        q, s = quantize_int8(x.reshape(-1))
        e = quant_error(x.reshape(-1, BLOCK), q, s)
        return q.view(lr, -1), s.view(lr, -1), e.view(lr, -1)

    def dequant(q, s):
        return dequantize_int8(q.reshape(-1, BLOCK), s.reshape(-1, 1)).view(lr, -1)

    # reduce-scatter: hop h ships segment (r+1+h) % p to rank r-1 as int8
    # (+ f32 block scales) and captures its requantization error in that
    # segment's row; after p-1 hops rank r holds the sum of segment r.
    send_seg = segs[rows, (r + 1) % p]
    for h in range(p - 1):
        q, s, e = quant(send_seg)
        err[rows, (r + 1 + h) % p] = e
        q, s = group.exchange([q, s], p - 1)
        # the jitted reference contracts this add and the dequantize's
        # product into one fused multiply-add
        send_seg = fma_f32(segs[rows, (r + 2 + h) % p].view(lr, -1, BLOCK),
                           q.view(lr, -1, BLOCK), s.view(lr, -1, 1)).view(lr, -1)
    # all-gather the reduced segment sums (int8 on the wire); the final
    # quantize's error stays in sum units in the rank's own row
    q, s, e = quant(send_seg)
    err[rows, r] = e
    out = torch.zeros_like(segs)
    out[rows, r] = dequant(q, s)
    for h in range(1, p):
        q, s = group.exchange([q, s], 1)
        out[rows, (r - h) % p] = dequant(q, s)
    return out.reshape(lr, m) * inv(p), err.reshape(lr, m)


def compressed_allreduce_tree(grads, errors, group, *,
                              transport: str = "circulant",
                              backend: str = "cuda",
                              n_blocks: Optional[int] = None,
                              qblock: Optional[int] = None):
    """Lossy mean-allreduce of a gradient tree with error feedback.

    Every leaf has a leading axis over ``group.ranks``; ``errors`` is the
    previous step's error state (f32 leaves, sum units; start from
    :func:`init_error_state`).  Gradient leaves may be bf16/f16/f32: they
    are widened to f32 for the transport and the mean is cast back, the
    downcast loss folded into the returned error (which stays f32).  A
    ragged leaf is padded, the pad tail's error folded into the last real
    element.  Returns ``(mean_grads, new_errors)``.
    """
    if transport not in ("circulant", "ring"):
        raise ValueError(f"unknown transport {transport!r} "
                         "(use 'circulant' or 'ring')")
    flat_g, treedef = tree_flatten(grads)
    flat_e, _ = tree_flatten(errors)
    p = group.p
    targets = [g.to(torch.float32).reshape(g.shape[0], -1)
               + e.reshape(e.shape[0], -1) for g, e in zip(flat_g, flat_e)]
    if transport == "circulant":
        sums, errs = circulant_qallreduce(group, targets, n_blocks=n_blocks,
                                          backend=backend, qblock=qblock)
        means = [s * inv(p) for s in sums]
    else:
        qb = BLOCK if qblock is None else int(qblock)
        means, errs = [], []
        for tgt in targets:
            lr, size = tgt.shape
            pad = (-size) % (p * qb)
            padded = torch.cat([tgt, tgt.new_zeros((lr, pad))], dim=1)
            red, e = compressed_psum_ring(padded, group)
            # fold the pad tail's error into the last real element
            tail = e[:, size:].sum(1)
            e = e[:, :size].clone()
            e[:, size - 1] += tail
            means.append(red[:, :size])
            errs.append(e)
    outs, new_errs = [], []
    for g, m, e in zip(flat_g, means, errs):
        cast, delta = _cast_with_delta(m, g.dtype)
        outs.append(cast.reshape(g.shape))
        new_errs.append((e + delta).reshape(g.shape))
    return tree_unflatten(treedef, outs), tree_unflatten(treedef, new_errs)


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
    return [b[0] for b in _bucket_rows([x[None] for x in leaves], spec)]


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


def _bucket_rows(leaves: Sequence[torch.Tensor], spec: BucketSpec) -> List[torch.Tensor]:
    """The f32 buckets of leaves that carry a leading axis of held ranks
    -> ``[rows, bucket_size]`` each."""
    if len(leaves) != len(spec.leaf_sizes):
        raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                         f"{len(spec.leaf_sizes)}")
    parts: List[List[torch.Tensor]] = [[] for _ in spec.bucket_sizes]
    for leaf, b in zip(leaves, spec.assignment):
        parts[b].append(leaf.to(torch.float32).reshape(leaf.shape[0], -1))
    out = []
    for b, chunk in enumerate(parts):
        v = torch.cat(chunk, dim=1) if len(chunk) > 1 else chunk[0]
        if v.shape[1] != spec.bucket_sizes[b]:
            raise ValueError(f"bucket {b} has {v.shape[1]} elements, "
                             f"spec expects {spec.bucket_sizes[b]}")
        out.append(v)
    return out


def compressed_grad_sync(grads, err_buckets, group, spec: BucketSpec, *,
                         backend: str = "cuda",
                         n_blocks: Optional[int] = None,
                         qblock: Optional[int] = None):
    """Bucketed quantized-circulant gradient sync over ``group``.

    ``grads``: each held rank's local (unreduced) gradient, every leaf
    with a leading axis over ``group.ranks``; ``err_buckets``: the
    ``[len(group.ranks), bucket_size]`` f32 error buckets of
    :func:`init_grad_sync_state`.  All buckets ride ONE quantized
    circulant allreduce call (one schedule, one cached plan).  Returns
    ``(mean_grads, new_err_buckets)``: the mean in the gradients' dtypes
    (every rank's row the same) and the new errors, the downcast losses
    folded in.
    """
    leaves, treedef = tree_flatten(grads)
    flats = _bucket_rows(leaves, spec)
    targets = [f + e for f, e in zip(flats, err_buckets)]
    del flats
    sums, errs = circulant_qallreduce(group, targets, n_blocks=n_blocks,
                                      backend=backend, qblock=qblock)
    del targets
    p = group.p
    outs = []
    for leaf, b, off, n in zip(leaves, spec.assignment, spec.offsets,
                               spec.leaf_sizes):
        cast, delta = _cast_with_delta(sums[b][:, off:off + n] * inv(p),
                                       leaf.dtype)
        outs.append(cast.reshape(leaf.shape))
        errs[b][:, off:off + n] += delta
    return tree_unflatten(treedef, outs), tuple(errs)


def _sync_stream(group, device: torch.device):
    """The side stream the streamed bucket syncs of ``group`` run on: a
    :class:`StackedGroup`'s own on the card; None where they run inline
    (the CPU, and a ``DistGroup``, whose gloo allreduce would need a
    thread of its own a bucket to overlap)."""
    if isinstance(group, StackedGroup) and device.type == "cuda":
        return side_stream(("bucket_sync", group), device)
    return None


def _sync_bucket(target: torch.Tensor, meta) -> tuple:
    """One bucket's quantized allreduce of ``target`` ``[lr, size]`` ->
    the gradients of :class:`_BucketSync`'s inputs: ``(new_err, None,
    *leaf_means)``, each mean cast to its leaf's dtype, the downcast
    losses folded into the new error."""
    shapes, group, backend, _, n_blocks, qblock = meta
    (total,), (new_err,) = circulant_qallreduce(
        group, [target], n_blocks=n_blocks, backend=backend, qblock=qblock)
    mean = total * inv(group.p)
    out, off = [], 0
    for shape, dtype in shapes:
        size = _numel_of(shape)
        cast, delta = _cast_with_delta(mean[:, off:off + size], dtype)
        out.append(cast[0].reshape(shape))
        new_err[:, off:off + size] += delta
        off += size
    return (new_err, None) + tuple(out)


class _BucketSync(torch.autograd.Function):
    """One bucket's streamed sync marker: the identity on the bucket's
    leaves in the forward (each leaf viewed once a held rank); the
    backward runs the bucket's quantized allreduce on
    ``(acc + cotangents) * accum_scale + err`` and returns the mean as
    the leaves' gradient and the new error as the error's.

    On the card, over a :class:`StackedGroup`, the backward computes the
    target on the autograd stream and leaves the allreduce, the mean, its
    downcast and the error update on the group's bucket-sync stream
    (:func:`_sync_stream`), where they overlap the backward of the
    buckets still to come; it returns without waiting.  The caller makes
    its stream wait (:func:`wait_streamed_sync`) before it reads the
    gradients.  Elsewhere the allreduce runs inline."""

    @staticmethod
    def forward(ctx, meta, err, acc, *leaves):
        ctx.meta = meta
        ctx.save_for_backward(err, acc)
        lr = err.shape[0]
        return tuple(x.unsqueeze(0).expand(lr, *x.shape) for x in leaves)

    @staticmethod
    def backward(ctx, *cts):
        err, acc = ctx.saved_tensors
        group, accum_scale = ctx.meta[1], ctx.meta[3]
        lr = err.shape[0]
        parts = [ct.to(torch.float32).reshape(lr, -1) for ct in cts]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        target = (acc + flat) * accum_scale + err
        side = _sync_stream(group, target.device)
        if side is None:
            return (None,) + _sync_bucket(target, ctx.meta)
        cur = torch.cuda.current_stream(target.device)
        side.wait_stream(cur)
        target.record_stream(side)
        with torch.cuda.stream(side):
            grads = _sync_bucket(target, ctx.meta)
        for g in grads:
            if g is not None:
                g.record_stream(cur)
        return (None,) + grads


def _numel_of(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def streamed_sync_params(params, err_buckets, acc_buckets, spec: BucketSpec,
                         group, *, backend: str = "cuda",
                         accum_scale: float = 1.0,
                         n_blocks: Optional[int] = None,
                         qblock: Optional[int] = None):
    """Wrap each parameter bucket in a streamed sync marker.

    ``params``: the (replicated) parameter tree; ``err_buckets`` and
    ``acc_buckets``: ``[len(group.ranks), bucket_size]`` f32 error state
    and previously accumulated raw gradient buckets (zeros with no
    accumulation).  Returns a tree like ``params`` whose leaves gain a
    leading axis over ``group.ranks``: row i is rank ``group.ranks[i]``'s
    view of the parameter, the identity in the forward.  When a loss
    computed through row i of the returned tree (each rank its own batch)
    is differentiated, the gradient of ``params`` is the error-fed lossy
    mean of ``(acc + local_grads) * accum_scale`` -- each bucket synced
    by its marker as the backward completes its cotangents -- and the
    gradient of ``err_buckets`` is the new error state (sum units, the
    downcast losses folded in, as :func:`compressed_grad_sync`).

    On the card, over a :class:`StackedGroup`, each bucket's sync runs on
    a side stream while the backward of the buckets after it goes on, as
    the reference's ``streamed_body`` lets XLA schedule it: once the
    backward returns, call :func:`wait_streamed_sync` before reading
    either gradient.  Over a ``DistGroup`` the allreduce runs inline in
    the backward.
    """
    leaves, treedef = tree_flatten(params)
    if len(leaves) != len(spec.leaf_sizes):
        raise ValueError(f"params tree has {len(leaves)} leaves, spec "
                         f"expects {len(spec.leaf_sizes)}")
    if len(err_buckets) != spec.num_buckets:
        raise ValueError(f"{len(err_buckets)} error buckets, spec expects "
                         f"{spec.num_buckets}")
    # Each bucket's plan is built now: inside the backward the upload of
    # its device tables would make the host wait.
    comm = get_comm(group, backend=backend)
    for size in spec.bucket_sizes:
        comm.plan("quantized_allreduce",
                  [torch.empty((len(group.ranks), size), device="meta")],
                  n_blocks=n_blocks, qblock=qblock)
    groups: List[List[torch.Tensor]] = [[] for _ in spec.bucket_sizes]
    for leaf, b in zip(leaves, spec.assignment):
        groups[b].append(leaf)
    synced = []
    for b, members in enumerate(groups):
        meta = (tuple((tuple(x.shape), x.dtype) for x in members), group,
                backend, float(accum_scale), n_blocks, qblock)
        synced.append(list(_BucketSync.apply(meta, err_buckets[b],
                                             acc_buckets[b], *members)))
    # stitch the bucket groups back into flatten order
    out, taken = [], [0] * spec.num_buckets
    for b in spec.assignment:
        out.append(synced[b][taken[b]])
        taken[b] += 1
    return tree_unflatten(treedef, out)


def wait_streamed_sync(group, device) -> None:
    """Make the current stream wait for the bucket syncs that a backward
    through :func:`streamed_sync_params` left on ``group``'s bucket-sync
    stream; a no-op where they ran inline.  Call it once the backward
    has returned, before the gradients or the new error state are read."""
    side = _sync_stream(group, torch.device(device))
    if side is not None:
        torch.cuda.current_stream(side.device).wait_stream(side)
