"""Per-call entry points of the circulant collective family.

Port of ``repro.core.collectives``: the ``circulant_*`` functions are
shims over the plan/execute communicator of :mod:`repro_torch.core.comm`
-- prefer

    comm = get_comm(group, backend=..., model=...)
    plan = comm.plan(kind, payload_spec, n_blocks=..., root=..., op=...)
    out = plan(payload)       # or comm.broadcast(x, ...) etc.

which keeps plan construction out of the hot path.  Each shim resolves
the process-cached communicator and plan on every call, so it shares
the plans of first-class communicator users but pays a plan-cache
lookup a call.  ``group`` is a :class:`~repro_torch.core.comm.StackedGroup`
or a :class:`~repro_torch.core.comm.DistGroup`; ``circulant_qallreduce``
is the int8-wire allreduce the gradient sync runs.  ``ring_allgather`` is
the classic p-1 round ring, the baseline of the circulant allgather.  The
``hier_*`` two-level wrappers of :mod:`repro_torch.core.hier` are
re-exported here.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from .comm import check_devices, get_comm
from .costmodel import DEFAULT_MODEL, CommModel
# The two-level one-call entry points live in repro_torch.core.hier;
# re-exported here so flat and hierarchical call sites share one import.
from .hier import (  # noqa: F401  (re-exports)
    hier_allgather,
    hier_allreduce,
    hier_broadcast,
    hier_reduce,
)

__all__ = [
    "circulant_broadcast",
    "circulant_allgather",
    "circulant_allgatherv",
    "circulant_allbroadcast",
    "circulant_reduce",
    "circulant_reduce_scatter",
    "circulant_allreduce",
    "circulant_qallreduce",
    "hier_broadcast",
    "hier_reduce",
    "hier_allreduce",
    "hier_allgather",
    "ring_allgather",
]


# ------------------------------------------------------------------- shims


def circulant_broadcast(group: Any, x: torch.Tensor, *,
                        n_blocks: Optional[int] = None, root: int = 0,
                        backend: str = "cuda", model: CommModel = DEFAULT_MODEL):
    """Round-optimal n-block broadcast of ``x[root]``: ``x`` has one slice
    a rank along its leading axis (only the root's content matters); every
    slice of the result equals ``x[root]``, in n-1+ceil(log2 p) rounds."""
    return get_comm(group, backend=backend, model=model).broadcast(
        x, n_blocks=n_blocks, root=root)


def circulant_allgather(group: Any, x: torch.Tensor, *,
                        n_blocks: Optional[int] = None, backend: str = "cuda",
                        model: CommModel = DEFAULT_MODEL):
    """All-to-all broadcast of equal contributions along the leading axis:
    returns the whole gathered array (every rank holds it) in
    n-1+ceil(log2 p) rounds."""
    return get_comm(group, backend=backend, model=model).allgather(
        x, n_blocks=n_blocks)


def circulant_allgatherv(group: Any, x: torch.Tensor, sizes: Sequence[int], *,
                         n_blocks: Optional[int] = None, backend: str = "cuda",
                         model: CommModel = DEFAULT_MODEL):
    """Irregular allgather: ``x`` is [p, cap] (one row a rank), rank j's
    contribution ``x[j, :sizes[j]]``; returns the [p, cap] array with row
    j rank j's data, zero past ``sizes[j]``.  The wire carries
    ``sum(sizes)``, not ``p * max(sizes)``."""
    return get_comm(group, backend=backend, model=model).allgatherv(
        x, sizes, n_blocks=n_blocks)


def circulant_reduce_scatter(group: Any, x: torch.Tensor, *,
                             n_blocks: Optional[int] = None,
                             backend: str = "cuda",
                             model: CommModel = DEFAULT_MODEL):
    """Round-optimal reduce-scatter by time reversal of the all-to-all
    broadcast: ``x`` is [p, L] (row r rank r's contribution, L = p *
    shard); row r of the [p, shard] result is the sum of all rows'
    shard r."""
    return get_comm(group, backend=backend, model=model).reduce_scatter(
        x, n_blocks=n_blocks)


def circulant_reduce(group: Any, x: torch.Tensor, *,
                     n_blocks: Optional[int] = None, root: int = 0,
                     op: str = "sum", backend: str = "cuda",
                     model: CommModel = DEFAULT_MODEL):
    """Round-optimal n-block reduction to ``root`` (reversed Algorithm 1):
    the root's slice is the op-reduction (``"sum"`` or ``"max"``) of all
    slices, every other slice zero, in n-1+ceil(log2 p) rounds."""
    return get_comm(group, backend=backend, model=model).reduce(
        x, n_blocks=n_blocks, root=root, op=op)


def circulant_allreduce(group: Any, x: torch.Tensor, *,
                        n_blocks: Optional[int] = None, root: int = 0,
                        op: str = "sum", backend: str = "cuda",
                        model: CommModel = DEFAULT_MODEL):
    """All-reduction in the composed 2(n-1)+2*ceil(log2 p) rounds: reduce
    to ``root``, then broadcast back, on one bundle and block count."""
    return get_comm(group, backend=backend, model=model).allreduce(
        x, n_blocks=n_blocks, root=root, op=op)


def circulant_allbroadcast(group: Any, x: torch.Tensor, *,
                           n_blocks: Optional[int] = None,
                           backend: str = "cuda",
                           model: CommModel = DEFAULT_MODEL):
    """All-broadcast, the family's name (arXiv:2407.18004) for
    :func:`circulant_allgather`: the same plan."""
    return get_comm(group, backend=backend, model=model).allbroadcast(
        x, n_blocks=n_blocks)


def circulant_qallreduce(group: Any, flats: Sequence[torch.Tensor], *,
                         n_blocks: Optional[int] = None, root: int = 0,
                         backend: str = "cuda", qblock: Optional[int] = None,
                         model: CommModel = DEFAULT_MODEL):
    """The quantized circulant allreduce of a list of float32 vectors,
    each ``[len(group.ranks), size]`` (one row a held rank) ->
    ``(sums, errs)`` lists: the lossy sums (every rank's row the same)
    and each rank's own quantization error in sum units, so that
    ``exact_sum == sums + sum_over_ranks(errs)`` to f32 rounding; divide
    by ``group.p`` for a mean.  One plan of the communicator serves every
    call of the same shapes (the trainer's one frozen plan a bucket
    spec); at p = 1 nothing moves and the errors are zero."""
    sums, errs = get_comm(group, backend=backend, model=model).plan(
        "quantized_allreduce", list(flats), n_blocks=n_blocks, root=root,
        qblock=qblock)(list(flats))
    return list(sums), list(errs)


# ----------------------------------------------------------- ring baseline


def ring_allgather(group: Any, x: torch.Tensor) -> torch.Tensor:
    """The classic p-1 round ring allgather (bandwidth-optimal, latency
    p-1 rounds against the circulant's n-1+ceil(log2 p)): every round
    each rank passes on what it received last.  Returns the whole
    gathered array, as :func:`circulant_allgather` does."""
    check_devices(group, [x])
    p = group.p
    if p == 1:
        return x
    ranks = group.ranks
    lr = len(ranks)
    x = torch.as_tensor(x, device=group.device)
    cur = x.reshape(lr, -1).contiguous()
    buf = torch.empty((lr, p) + tuple(cur.shape[1:]), dtype=x.dtype,
                      device=group.device)
    rows = torch.arange(lr, device=group.device)
    mine = torch.arange(ranks.start, ranks.stop, device=group.device)
    buf[rows, mine] = cur
    for i in range(1, p):
        (cur,) = group.exchange([cur], 1)
        buf[rows, (mine - i) % p] = cur      # the piece from rank r - i
    return buf[0].reshape((p * (x.shape[0] // lr),) + tuple(x.shape[1:]))
