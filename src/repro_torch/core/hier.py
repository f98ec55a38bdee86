"""Two-level hierarchical collectives: the host data plans.

Port of the host half of ``repro.core.hier``: ``HIER_KINDS``,
``hier_rounds``, the reduce and broadcast sweeps, ``HierHostPlan``,
``_AllreduceHostPlan`` and ``hier_host_plan``.  The paper evaluates its
broadcast on a 36-node x 32-core cluster; the two-level decomposition
runs one flat circulant collective per level:

  * ``broadcast``: inter-node broadcast among the node leaders (the
    root's core on every node), then the intra-node broadcast, which is
    the same on every node and so runs once;
  * ``reduce``: an intra-node reduction to each node's leader, node by
    node, then the inter-node reduction of the leader partials to the
    root;
  * ``allreduce``: the reduce sweep, then the broadcast sweep;
  * ``allgather``: an intra-node allgather of the cores' contributions,
    node by node, then the inter-node allgather of the node blocks.

Flat ranks are node-major, ``r = node * cores + core``.  Each level is
the port's own cached flat :func:`repro_torch.core.comm.host_plan` (a
one-rank level is ``None`` and passes its data through), so the levels
run the round-step kernels of :mod:`repro_torch.kernels` on a CUDA
device.  Between the levels the flat ``[m]`` payload is re-blocked to
``[n, ceil(m/n)]`` with zero padding, and the padding is sliced off
again (``[:m]``) before the next level, exactly where the reference
does.  Data stays on the plans' device from the first phase to the
last: ``run`` takes a numpy array or a tensor and returns tensors.

The reference checks with one ``np.array_equal`` per node (or per
node and core) that the copies a level leaves on its ranks agree; here
each such check is one batched comparison of the bits per level, so a
run synchronises with the host once a level, and a failure raises the
same ``AssertionError`` text, naming the first index that diverges.
Comparing bits, a NaN payload agrees with itself, where
``np.array_equal`` would call it diverged.

The device half of ``repro.core.hier`` (``HierComm``, ``HierPlan``,
``_lower_hier`` and the ``hier_*`` wrappers) runs over a 2-D grid of
processes; it waits for the port's plan/execute front end over
``torch.distributed`` (``ROADMAP.md`` Queue 1 items 5 and 8b).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

import torch

from ..kernels.reduce_ops import _validate
from .comm import _as_tensor, host_plan, resolve_device
from .engine import cached_plan
from .roundstep import BACKENDS, PhaseStatic
from .schedule import num_rounds

__all__ = [
    "HIER_KINDS",
    "hier_rounds",
    "HierHostPlan",
    "hier_host_plan",
]

#: Collective kinds the hierarchical layer composes.  ``"allbroadcast"``
#: is the family alias and canonicalizes onto ``"allgather"``.
HIER_KINDS = ("broadcast", "reduce", "allreduce", "allgather", "allbroadcast")

_CANONICAL_KIND = {"allbroadcast": "allgather"}

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def hier_rounds(kind: str, nodes: int, cores: int,
                n_inter: int, n_intra: int) -> int:
    """Composed closed-form round count of a two-level collective.

    Each level contributes its flat optimum (``n-1+ceil(log2 p)``, 0 on
    a one-rank level); broadcast / reduce / allgather run one phase per
    level, the all-reduction runs both directions at both levels:
    ``2(n_C-1+q_C) + 2(n_N-1+q_N)``.
    """
    kind = _CANONICAL_KIND.get(kind, kind)
    if kind not in ("broadcast", "reduce", "allreduce", "allgather"):
        raise ValueError(f"unknown hier kind {kind!r} "
                         f"(use one of {HIER_KINDS})")
    per_level = num_rounds(nodes, n_inter) + num_rounds(cores, n_intra)
    return 2 * per_level if kind == "allreduce" else per_level


# ------------------------------------------------------------ the seam


def _split(flat: torch.Tensor, n: int) -> torch.Tensor:
    """The re-blocking between the levels: ``[..., m] -> [..., n,
    ceil(m/n)]``, zero padded at the end, on the tensor's own device.
    A view where n divides m."""
    m = flat.shape[-1]
    bs = -(-m // n)
    lead = tuple(flat.shape[:-1])
    if m == n * bs:
        return flat.reshape(lead + (n, bs))
    out = flat.new_zeros(lead + (n * bs,))
    out[..., :m] = flat
    return out.view(lead + (n, bs))


def _prefix(blocks: torch.Tensor, m: int) -> torch.Tensor:
    """``[..., n, bs]`` blocks -> their first m elements, ``[..., m]``
    (the padding sliced off)."""
    return blocks.reshape(tuple(blocks.shape[:-2]) + (-1,))[..., :m]


def _rows_differ(got: torch.Tensor, m: int) -> torch.Tensor:
    """bool ``[rows - 1]`` on the device: whether row r >= 1 of ``got``
    (``[rows, ..., n, bs]``) differs from row 0 in the bits of the first
    m elements of each ``[n, bs]`` run of blocks (a padded tail is not
    compared, as the reference compares ``[:m]``)."""
    b = got.view(_BITS[got.element_size()])
    bs = got.shape[-1]
    full, tail = divmod(m, bs) if bs else (0, 0)
    differ = (b[1:, ..., :full, :] != b[:1, ..., :full, :]).flatten(1).any(1)
    if tail:
        differ |= (b[1:, ..., full, :tail]
                   != b[:1, ..., full, :tail]).flatten(1).any(1)
    return differ


def _assert_agree(differ: torch.Tensor, msg: str) -> None:
    """Raise ``AssertionError(msg.format(*index))`` at the first True of
    ``differ`` (rows counted from 1, as row 0 is the reference copy):
    one host synchronisation for a whole level."""
    if bool(differ.any()):
        first = [int(i) for i in differ.nonzero()[0]]
        first[-1] += 1
        raise AssertionError(msg.format(*first))


# ------------------------------------------------------------ the sweeps


def _reduce_sweep(vals, nodes, cores, n_inter, n_intra, intra_red,
                  inter_red, root_node, root_core) -> torch.Tensor:
    """Reduction sweep: ``[nodes, cores, m]`` contributions on the plans'
    device -> the flat ``[m]`` op-reduction at the root, via per-node
    intra reductions to the leaders then one inter reduction (a
    one-rank level passes through).  Shared by the reduce and allreduce
    host plans."""
    m = vals.shape[-1]
    if intra_red is not None:
        # Each node's partial is copied out of its run's buffer at once,
        # so no node's partial can alias another's, and one node's
        # buffer at a time is alive.
        partials = vals.new_empty((nodes, m))
        for j in range(nodes):
            got = intra_red.run(_split(vals[j], n_intra))     # [cores, n, bs]
            partials[j] = _prefix(got[root_core], m)
    else:
        partials = vals[:, 0]
    if inter_red is not None:
        got = inter_red.run(_split(partials, n_inter))       # [nodes, n, bs]
        return _prefix(got[root_node], m)
    return partials[0]


def _bcast_sweep(vals, nodes, cores, n_inter, n_intra, inter_bc,
                 intra_bc) -> torch.Tensor:
    """Broadcast sweep: the flat ``[m]`` payload at the root -> the final
    ``[nodes, cores, m]`` state of every rank, via the inter-node leader
    broadcast then the (node-identical) intra fan-out, run once: the
    result is a view that repeats the intra level's ``[cores, m]`` for
    every node.  The leaders' agreement is checked.  Shared by the
    broadcast and allreduce host plans."""
    vals = vals.reshape(-1)
    m = vals.shape[0]
    leader = vals
    if inter_bc is not None:
        got = inter_bc.run(_split(vals, n_inter))            # [nodes, n, bs]
        # every node leader ends with the root's payload
        _assert_agree(_rows_differ(got, m),
                      "hier broadcast sweep: node leader {} diverged")
        leader = _prefix(got[0], m)
    if intra_bc is not None:
        got = intra_bc.run(_split(leader, n_intra))          # [cores, n, bs]
        percore = _prefix(got, m)
    else:
        percore = leader[None]
    return percore.expand(nodes, cores, m)


# ------------------------------------------------------------ plan objects


@dataclass(frozen=True, eq=False)
class HierHostPlan:
    """Precomputed hierarchical host data-plane execution.

    Composes the cached flat :class:`~repro_torch.core.comm.HostDataPlan`
    of each level; ``run(values)`` executes only the per-level rounds
    plus the re-blocking seam.
    """

    kind: str
    nodes: int
    cores: int
    n_inter: int
    n_intra: int
    root: int
    op: Optional[str]
    backend: str
    device: torch.device
    inter: Any = field(repr=False)   # flat HostDataPlan or None (level of 1)
    intra: Any = field(repr=False)

    @property
    def root_node(self) -> int:
        return self.root // self.cores

    @property
    def root_core(self) -> int:
        return self.root % self.cores

    @property
    def statics(self) -> Tuple[PhaseStatic, ...]:
        """Composed per-phase audit records in run order, delegated to
        the per-level flat host plans (a one-rank level contributes
        nothing)."""
        inter = self.inter.statics if self.inter is not None else ()
        intra = self.intra.statics if self.intra is not None else ()
        return inter + intra if self.kind == "broadcast" else intra + inter

    def _on_device(self, values) -> torch.Tensor:
        return _as_tensor(values).to(self.device)

    def run(self, values) -> torch.Tensor:
        if self.kind == "broadcast":
            return self._run_broadcast(values)
        if self.kind == "reduce":
            return self._run_reduce(values)
        # allreduce is always built as _AllreduceHostPlan (its levels
        # hold (reduce, broadcast) plan pairs this base class cannot run)
        assert self.kind == "allgather", self.kind
        return self._run_allgather(values)

    def _run_broadcast(self, values) -> torch.Tensor:
        """``values``: flat [m] payload at flat rank ``root`` -> the final
        [nodes, cores, m] state of every rank (a view that repeats one
        node's [cores, m] for every node)."""
        return _bcast_sweep(self._on_device(values), self.nodes, self.cores,
                            self.n_inter, self.n_intra, self.inter,
                            self.intra)

    def _run_reduce(self, values) -> torch.Tensor:
        """``values``: [nodes, cores, m] contributions -> flat [m]
        op-reduction (the state of flat rank ``root``)."""
        vals = self._on_device(values).reshape(self.nodes, self.cores, -1)
        return _reduce_sweep(vals, self.nodes, self.cores, self.n_inter,
                             self.n_intra, self.intra, self.inter,
                             self.root_node, self.root_core)

    def _run_allgather(self, values) -> torch.Tensor:
        """``values``: [nodes, cores, e] contributions -> flat
        [nodes*cores, e] rank-major result (identical on every rank;
        agreement checked once a level)."""
        nodes, cores = self.nodes, self.cores
        vals = self._on_device(values).reshape(nodes, cores, -1)
        e = vals.shape[-1]
        if self.intra is not None:
            node_blocks = vals.new_empty((nodes, cores, e))
            differ = vals.new_empty((nodes, cores - 1), dtype=torch.bool)
            for j in range(nodes):
                got = self.intra.run(_split(vals[j], self.n_intra))
                # got: [C_rank, C_root, n, bs]
                differ[j] = _rows_differ(got, e)
                node_blocks[j] = _prefix(got[0], e)
            _assert_agree(differ, "hier allgather: node {} rank {} diverged")
            node_blocks = node_blocks.view(nodes, cores * e)
        else:
            node_blocks = vals[:, 0]
        if self.inter is not None:
            sz = node_blocks.shape[-1]
            got = self.inter.run(_split(node_blocks, self.n_inter))
            # got: [N_rank, N_root, n, bs]
            _assert_agree(_rows_differ(got, sz),
                          "hier allgather: inter rank {} diverged")
            out = _prefix(got[0], sz)
        else:
            out = node_blocks
        return out.reshape(nodes * cores, e)


@dataclass(frozen=True, eq=False)
class _AllreduceHostPlan(HierHostPlan):
    """Hier allreduce host plan: per level, ``inter``/``intra`` hold a
    (reduce_plan, broadcast_plan) pair instead of one flat plan; the
    run is the reduction sweep followed by the broadcast sweep."""

    @property
    def statics(self) -> Tuple[PhaseStatic, ...]:
        red_n, bc_n = self.inter if self.inter is not None else (None, None)
        red_c, bc_c = self.intra if self.intra is not None else (None, None)
        out: Tuple[PhaseStatic, ...] = ()
        for plan in (red_c, red_n, bc_n, bc_c):  # the composed run order
            if plan is not None:
                out = out + plan.statics
        return out

    def run(self, values) -> torch.Tensor:
        red_n, bc_n = self.inter if self.inter is not None else (None, None)
        red_c, bc_c = self.intra if self.intra is not None else (None, None)
        vals = self._on_device(values).reshape(self.nodes, self.cores, -1)
        total = _reduce_sweep(vals, self.nodes, self.cores, self.n_inter,
                              self.n_intra, red_c, red_n,
                              self.root_node, self.root_core)
        return _bcast_sweep(total, self.nodes, self.cores, self.n_inter,
                            self.n_intra, bc_n, bc_c)


def hier_host_plan(kind: str, nodes: int, cores: int, n_inter: int,
                   n_intra: int, *, root: int = 0, op: str = "sum",
                   backend: str = "cuda",
                   device: Union[str, torch.device, None] = None
                   ) -> HierHostPlan:
    """The cached :class:`HierHostPlan` of a two-level collective over
    ``nodes x cores`` ranks on one device.

    ``kind``: ``"broadcast"``, ``"reduce"`` (``op``: ``"sum"``/``"+"`` or
    ``"max"``), ``"allreduce"`` or ``"allgather"`` (alias
    ``"allbroadcast"``; ``root`` is ignored).  ``root`` is the flat
    node-major rank ``node * cores + core``.  ``n_inter``/``n_intra``
    are the levels' block counts
    (:func:`repro_torch.core.costmodel.optimal_hier_blocks`).
    ``backend``: ``"cuda"`` (the kernels) or ``"torch"`` (the plain
    versions).  ``device=None`` means ``"cuda"`` and raises with no card.
    Equal arguments return the identical plan object.
    """
    kind = _CANONICAL_KIND.get(kind, kind)
    if kind not in ("broadcast", "reduce", "allreduce", "allgather"):
        raise ValueError(f"unknown hier host data-plane kind {kind!r}")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown round-step backend {backend!r} (use one of {BACKENDS})")
    nodes, cores = int(nodes), int(cores)
    rooted = kind in ("broadcast", "reduce", "allreduce")
    root_key = int(root) if rooted else 0
    if not 0 <= root_key < max(1, nodes * cores):
        raise ValueError(f"root must be in [0, nodes*cores), got {root} for "
                         f"{nodes}x{cores}")
    op_key = op if kind in ("reduce", "allreduce") else None
    if op_key is not None:
        _validate(op_key)
    dev = resolve_device(device)
    key = ("hierhostplan", kind, nodes, cores, int(n_inter), int(n_intra),
           root_key, op_key, backend, str(dev))

    def build():
        rootN, rootC = divmod(root_key, cores)
        common = dict(kind=kind, nodes=nodes, cores=cores,
                      n_inter=int(n_inter), n_intra=int(n_intra),
                      root=root_key, op=op_key, backend=backend, device=dev)

        def flat(flat_kind, p, n, level_root):
            return host_plan(flat_kind, p, n, root=level_root, op=op,
                             backend=backend, device=dev)

        if kind == "allreduce":
            # the composed run needs both directions; cache the four flat
            # plans eagerly so run() is pure execution.
            inter = ((flat("reduce", nodes, n_inter, rootN),
                      flat("broadcast", nodes, n_inter, rootN))
                     if nodes > 1 else None)
            intra = ((flat("reduce", cores, n_intra, rootC),
                      flat("broadcast", cores, n_intra, rootC))
                     if cores > 1 else None)
            return _AllreduceHostPlan(inter=inter, intra=intra, **common)
        return HierHostPlan(
            inter=flat(kind, nodes, n_inter, rootN) if nodes > 1 else None,
            intra=flat(kind, cores, n_intra, rootC) if cores > 1 else None,
            **common)

    return cached_plan(key, build)
