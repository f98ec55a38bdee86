"""Two-level hierarchical collectives over a nodes x cores grid of ranks.

Port of ``repro.core.hier``.  The paper evaluates its broadcast on a
36-node x 32-core cluster; the two-level decomposition runs one flat
circulant collective per level:

  * ``broadcast``: inter-node broadcast among the node leaders (the
    root's core on every node), then the intra-node broadcast;
  * ``reduce``: an intra-node reduction to each node's leader, then the
    inter-node reduction of the leader partials to the root;
  * ``allreduce``: the reduce, then the broadcast;
  * ``allgather``: an intra-node allgather of the cores' contributions,
    then the inter-node allgather of the node blocks.

Flat ranks are node-major, ``r = node * cores + core``.  Between the
levels each rank's flat ``[m]`` payload is re-blocked into the next
level's n blocks of ``ceil(m/n)``, zero padded, exactly where the
reference does.

The device half is the plan/execute communicator over a grid:
``get_hier_comm(grid)`` returns a cached :class:`HierComm`, its
``plan(kind, payload, n_inter=, n_intra=, root=, op=)`` a cached
:class:`HierPlan`, and ``plan(payload)`` runs it on pytree payloads,
every leaf in its own dtype, all leaves on one schedule a level.  As in
the reference's ``_lower_hier``, each level runs once over all the
grid's ranks in lockstep: the inter level on every core row (only the
leader row's data means anything), the intra level in every node.  A
grid says where the ranks are:

  * :class:`StackedGrid`: all ``nodes * cores`` ranks on one device as
    the leading axis of every leaf; a level's exchange rolls
    ``view(nodes, cores, ...)`` along dim 0 (inter) or dim 1 (intra);
  * :class:`DistGrid`: one rank a process of a gloo group, its levels
    the node and core-column subgroups
    (:class:`~repro_torch.core.comm.DistGroup`).

The level phases are :mod:`repro_torch.core.comm`'s, the ones the flat
lowerings run, so a level launches each round-step kernel once a round
over all its rows.  ``hier_broadcast`` and friends are the one-call
wrappers.

The module also holds the host data plans (``HierHostPlan``,
``hier_host_plan``): single-device executions composing one cached flat
:func:`~repro_torch.core.comm.host_plan` a level (a one-rank level is
``None`` and passes its data through), the intra level node by node.
``run`` takes a numpy array or a tensor and returns tensors.  The
reference checks with one ``np.array_equal`` per node (or per node and
core) that the copies a level leaves on its ranks agree; here each such
check is one batched comparison of the bits per level, so a run
synchronises with the host once a level, and a failure raises the same
``AssertionError`` text, naming the first index that diverges.
Comparing bits, a NaN payload agrees with itself, where
``np.array_equal`` would call it diverged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels import row_roll
from ..kernels.reduce_ops import _validate
from . import trace
from .comm import (
    DistGroup,
    PayloadSpec,
    _allgather_phase,
    _as_tensor,
    _bcast_phase,
    _drain,
    _leaf_elems,
    _reduce_phase,
    _require,
    _row_of,
    check_devices,
    host_plan,
    observe_exchange,
    payload_spec,
    resolve_device,
    validate_payload,
)
from .costmodel import DEFAULT_MODEL, CommModel, optimal_hier_blocks
from .engine import cached_plan, get_bundle, traced_plan
from .roundstep import (
    BACKENDS,
    PhaseStatic,
    allgather_phase_static,
    broadcast_phase_static,
    get_round_step,
    reduce_phase_static,
)
from .schedule import num_rounds
from .tree import tree_flatten, tree_unflatten

__all__ = [
    "HIER_KINDS",
    "hier_rounds",
    "StackedGrid",
    "DistGrid",
    "HierPlan",
    "HierComm",
    "get_hier_comm",
    "hier_broadcast",
    "hier_reduce",
    "hier_allreduce",
    "hier_allgather",
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


# ------------------------------------------------------------ the grids


def _grid_size(nodes, cores) -> Tuple[int, int]:
    nodes, cores = int(nodes), int(cores)
    if nodes < 1 or cores < 1:
        raise ValueError(f"a grid needs nodes, cores >= 1, got {nodes}x{cores}")
    return nodes, cores


@dataclass(frozen=True, eq=False)
class _StackedLevel:
    """One level of a :class:`StackedGrid`: the inter level (``dim`` 0,
    level rank ``row // cores``) or the intra level (``dim`` 1, level rank
    ``row % cores``).  Its exchange rolls each ``[nodes * cores, ...]``
    message, viewed ``[nodes, cores, ...]``, along ``dim``."""

    nodes: int
    cores: int
    dim: int
    device: torch.device

    @property
    def p(self) -> int:
        return self.cores if self.dim else self.nodes

    @property
    def ranks(self) -> np.ndarray:
        rows = np.arange(self.nodes * self.cores)
        return rows % self.cores if self.dim else rows // self.cores

    def exchange(self, msgs: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
        observe_exchange(self, msgs)
        grid = (self.nodes, self.cores)
        return [row_roll.roll(m.view(grid + tuple(m.shape[1:])), shift,
                              self.dim).view(m.shape) for m in msgs]


@dataclass(frozen=True)
class StackedGrid:
    """``nodes x cores`` ranks on one device: flat rank ``r = node * cores
    + core``'s slice of a payload leaf is row r of its leading axis (the
    reference's global array over the 2-D mesh, unsharded).  ``inter`` and
    ``intra`` are its two levels.  ``inter_axis`` and ``intra_axis`` name
    them, as the reference's mesh axes do.  ``device=None`` means
    ``"cuda"`` (the current card) and raises with no card."""

    nodes: int
    cores: int
    device: Union[str, torch.device, None] = None
    inter_axis: str = "node"
    intra_axis: str = "core"
    inter: _StackedLevel = field(init=False, repr=False, compare=False)
    intra: _StackedLevel = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        nodes, cores = _grid_size(self.nodes, self.cores)
        dev = resolve_device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        for name, value in (("nodes", nodes), ("cores", cores), ("device", dev),
                            ("inter", _StackedLevel(nodes, cores, 0, dev)),
                            ("intra", _StackedLevel(nodes, cores, 1, dev))):
            object.__setattr__(self, name, value)

    @property
    def p(self) -> int:
        return self.nodes * self.cores

    @property
    def ranks(self) -> range:
        """The flat ranks this process holds: all of them."""
        return range(self.p)

    def global_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return shape


@dataclass(frozen=True)
class DistGrid:
    """One rank a process of the initialized default ``torch.distributed``
    group of ``nodes * cores`` processes, flat rank = process rank.  Every
    process makes the subgroups of every node and every core column, in
    the same order; ``inter`` is a :class:`~repro_torch.core.comm.DistGroup`
    of its core column (level rank: its node), ``intra`` one of its node
    (level rank: its core), ``None`` on a one-rank level.  A leaf is the
    rank's shard of the reference's global array.  Only gloo groups are
    taken, so the tensors live on the CPU."""

    nodes: int
    cores: int
    inter_axis: str = "node"
    intra_axis: str = "core"
    rank: int = field(init=False)
    device: torch.device = field(init=False, repr=False)
    inter: Optional[DistGroup] = field(init=False, repr=False)
    intra: Optional[DistGroup] = field(init=False, repr=False)

    def __post_init__(self):
        import torch.distributed as dist

        nodes, cores = _grid_size(self.nodes, self.cores)
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "DistGrid needs an initialized torch.distributed process "
                "group: call torch.distributed.init_process_group first")
        backend = dist.get_backend()
        if backend != "gloo":
            raise ValueError(f"DistGrid runs over gloo only, not {backend!r}")
        world = dist.get_world_size()
        if world != nodes * cores:
            raise ValueError(f"a {nodes}x{cores} grid needs {nodes * cores} "
                             f"processes, the group has {world}")
        rank = dist.get_rank()
        node, core = divmod(rank, cores)
        # every process makes every subgroup, in one order
        inter = intra = None
        if cores > 1:
            groups = [dist.new_group([j * cores + c for c in range(cores)])
                      for j in range(nodes)]
            intra = DistGroup(group=groups[node])
        if nodes > 1:
            groups = [dist.new_group([j * cores + c for j in range(nodes)])
                      for c in range(cores)]
            inter = DistGroup(group=groups[core])
        for name, value in (("nodes", nodes), ("cores", cores), ("rank", rank),
                            ("device", torch.device("cpu")), ("inter", inter),
                            ("intra", intra)):
            object.__setattr__(self, name, value)

    @property
    def p(self) -> int:
        return self.nodes * self.cores

    @property
    def ranks(self) -> range:
        """The flat ranks this process holds: its own."""
        return range(self.rank, self.rank + 1)

    def global_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return (shape[0] * self.p,) + tuple(shape[1:]) if shape else shape


# ------------------------------------------------------------ the lowering


def _lower_hier(grid, kind: str, bN, bC, nN: int, nC: int, root: int,
                op: Optional[str], step) -> Tuple[Callable, tuple]:
    """``(execute, tables)``, where ``execute(leaves, copies=False) ->
    leaves`` runs the levels' phases over
    every rank of the grid, in the reference's order (one-rank levels
    compose away), each leaf split into its own blocks at every level.

      * broadcast: root mask, inter broadcast, intra broadcast.  The
        root mask is the inter phase's source row (the others start at
        zero); the intra phase's sources are the leaders, the rows of the
        root's core;
      * reduce: intra reduce, inter reduce, root mask;
      * allreduce: both reduces, then both broadcasts;
      * allgather: the intra phase, then the inter phase over each row's
        ``[cores, m]`` node block; the first held rank's copy of the
        replicated result, or (``copies``) every held rank's.

    A level's phase empties its input list as it copies each leaf in, so
    at most two levels' buffers are alive at once.  Each phase is a
    ``phase`` span of level ``inter`` or ``intra``; the drain and the
    reshape back to the leaves' shapes a ``phase.result``.  ``tables`` are the
    :class:`~repro_torch.core.comm.DeviceTable` records of the levels'
    slot tables, in the phases' run order."""
    N, C = bN.p, bC.p
    held, dev = grid.ranks, grid.device
    lr = len(held)
    rootC = root % C
    src_inter = _row_of(held, root)
    # the leaders: held rows on the root's core (on a 1 x C grid, the root)
    first = (rootC - held.start) % C
    src_intra = slice(first, lr, C)

    tables: tuple = ()

    def level(p, make, name, b, n, *args):
        nonlocal tables
        if p == 1:
            return None
        run, records = make(getattr(grid, name), b, n, *args, name=name)
        tables += records
        return run

    intra_g = inter_g = intra_r = inter_r = inter_b = intra_b = None
    if kind == "allgather":
        intra_g = level(C, _allgather_phase, "intra", bC, nC, step)
        inter_g = level(N, _allgather_phase, "inter", bN, nN, step)
    if kind in ("reduce", "allreduce"):
        intra_r = level(C, _reduce_phase, "intra", bC, nC, op, step)
        inter_r = level(N, _reduce_phase, "inter", bN, nN, op, step)
    if kind in ("broadcast", "allreduce"):
        inter_b = level(N, _bcast_phase, "inter", bN, nN, step)
        intra_b = level(C, _bcast_phase, "intra", bC, nC, step)

    def execute(leaves, copies=False):
        xs = [torch.as_tensor(x, device=dev) for x in leaves]
        flats = [x.reshape(lr, x.numel() // lr) for x in xs]
        if kind == "allgather":
            if intra_g is not None:
                flats = intra_g(flats)                 # [lr, C, m]
            if inter_g is not None:
                flats = inter_g(flats)                 # [lr, N, C*m]
            n_held = lr if copies else 1
            with trace.span("phase.result", device=dev):
                outs = [f[:n_held].reshape((n_held, N * C * (x.shape[0] // lr))
                                           + tuple(x.shape[1:]))
                        for f, x in zip(flats, xs)]
            return outs if copies else [o[0] for o in outs]
        if intra_r is not None:                        # each node to its leader
            flats = intra_r(flats)
        if inter_r is not None:                        # the leaders to the root
            flats = inter_r(flats)
        if kind == "reduce":
            with trace.span("phase.result", device=dev):
                for f in flats:
                    _drain(f, src_inter)
        if inter_b is not None:                        # the root to the leaders
            flats = inter_b(flats, src_inter)
        if intra_b is not None:                        # the leaders to their nodes
            flats = intra_b(flats, src_intra)
        with trace.span("phase.result", device=dev):
            return [f.reshape(x.shape) for f, x in zip(flats, xs)]

    return execute, tables


def _hier_statics(kind: str, bN, bC, nN: int, nC: int, inter_axis: str,
                  intra_axis: str) -> Tuple[PhaseStatic, ...]:
    """The per-phase audit records of a two-level collective, in
    :func:`_lower_hier`'s order (one-rank levels compose away), from the
    same process-cached slot plans the lowering runs."""
    N, C = bN.p, bC.p
    inter_b = ((broadcast_phase_static(bN, nN, axis=inter_axis),)
               if N > 1 else ())
    intra_b = ((broadcast_phase_static(bC, nC, axis=intra_axis),)
               if C > 1 else ())
    inter_r = ((reduce_phase_static(bN, nN, axis=inter_axis),)
               if N > 1 else ())
    intra_r = ((reduce_phase_static(bC, nC, axis=intra_axis),)
               if C > 1 else ())
    if kind == "broadcast":
        return inter_b + intra_b
    if kind == "reduce":
        return intra_r + inter_r
    if kind == "allreduce":
        return intra_r + inter_r + inter_b + intra_b
    inter_g = ((allgather_phase_static(bN, nN, axis=inter_axis),)
               if N > 1 else ())
    intra_g = ((allgather_phase_static(bC, nC, axis=intra_axis),)
               if C > 1 else ())
    return intra_g + inter_g


# ------------------------------------------------------------ plan objects


@dataclass(frozen=True, eq=False)
class HierPlan:
    """A fully precomputed two-level collective: call it with payloads.

    Every static artifact (both level bundles, the levels' slot tables on
    the device, the shifts, the round-step handle) was resolved at plan
    time; ``plan(payload)`` validates the payload and runs the rounds.
    Cached process-wide: equal specs return the identical object.
    """

    kind: str
    spec: PayloadSpec
    nodes: int
    cores: int
    root: int
    op: Optional[str]
    n_inter: int
    n_intra: int
    rounds: int
    rounds_inter: int
    rounds_intra: int
    backend: str
    inter_axis: str
    intra_axis: str
    grid: Any = field(repr=False, default=None)
    #: Auditable per-phase schedule statics in execution order; () on the
    #: p == 1 fast path.
    statics: Tuple[PhaseStatic, ...] = field(repr=False, default=())
    _execute: Optional[Callable] = field(repr=False, default=None)
    #: Every slot table the executor indexes, on the grid's device, with
    #: the host table it was built from; () on the p == 1 fast path.
    device_tables: Tuple[Any, ...] = field(repr=False, default=())

    @property
    def p(self) -> int:
        return self.nodes * self.cores

    def __call__(self, payload: Any) -> Any:
        with trace.span("hier.call", device=self._device, kind=self.kind):
            leaves = self._leaves(payload)
            if self._execute is None:  # p == 1 fast path: nothing moves
                return payload
            return tree_unflatten(self.spec.treedef, self._execute(leaves))

    def per_rank(self, payload: Any) -> Any:
        """Execute an allgather and return every held rank's copy of its
        replicated result: each leaf gains a leading axis over
        ``grid.ranks``.  ``plan(payload)`` returns the first copy."""
        _require(self.kind == "allgather",
                 f"per_rank applies to allgather, not {self.kind!r}")
        with trace.span("hier.call", device=self._device, kind=self.kind):
            leaves = self._leaves(payload)
            if self._execute is None:
                outs = [torch.as_tensor(x)[None] for x in leaves]
            else:
                outs = self._execute(leaves, copies=True)
            return tree_unflatten(self.spec.treedef, outs)

    @property
    def _device(self) -> Optional[torch.device]:
        return None if self.grid is None else self.grid.device

    def _leaves(self, payload: Any) -> list:
        with trace.span("comm.validate"):
            validate_payload(self.spec, payload)
            leaves, _ = tree_flatten(payload)
            if self.grid is not None:
                check_devices(self.grid, leaves)
            return leaves

    def describe(self) -> str:
        """One-line human summary of the plan."""
        extra = f" op={self.op}" if self.op else ""
        return (f"hier-{self.kind} mesh={self.nodes}x{self.cores} "
                f"root={self.root} n=({self.n_inter},{self.n_intra}) "
                f"rounds={self.rounds} (inter {self.rounds_inter} + intra "
                f"{self.rounds_intra}) backend={self.backend}{extra} "
                f"spec={self.spec.describe()}")


# --------------------------------------------------------- n-block choice


def _resolve_hier_blocks(kind: str, spec: PayloadSpec, nodes: int, cores: int,
                         n_inter: Optional[int], n_intra: Optional[int],
                         inter_model: CommModel,
                         intra_model: CommModel) -> Tuple[int, int]:
    """The levels' block counts for a spec of global shapes: each level's
    cost-model optimum (or the caller's), capped at the elements the level
    splits a leaf into."""
    p = nodes * cores
    elems, total = [], 0
    for shape, dtype in spec.leaves:
        if kind == "allgather":
            _require(len(shape) >= 1 and shape[0] % p == 0,
                     f"leading dim {shape[0] if shape else 0} not divisible "
                     f"by mesh size {nodes}x{cores}={p}")
            e = (shape[0] // p) * _leaf_elems(shape[1:])
        else:
            _require(len(shape) >= 1 and shape[0] == p,
                     "payload leaves must have leading axis == nodes*cores "
                     f"(one slice/rank); got {shape} for {nodes}x{cores}")
            e = _leaf_elems(shape[1:])
        elems.append(e)
        total += e * dtype.itemsize
    if kind == "allgather":
        # the inter level moves node blocks (the full p*e payload), the
        # intra level the node's share
        m_inter, m_intra = total * p, total * cores
    else:
        m_inter = m_intra = total
    auto_n, auto_c = optimal_hier_blocks(nodes, cores, m_inter, m_intra,
                                         inter_model, intra_model, kind=kind)
    cap = max(1, max(elems))
    if kind == "allgather":
        cap_intra = cap              # per-rank contribution elems
        cap_inter = cap * cores      # node-block elems
    else:
        cap_intra = cap_inter = cap
    nN = min(max(1, n_inter or auto_n), cap_inter)
    nC = min(max(1, n_intra or auto_c), cap_intra)
    return nN, nC


# ---------------------------------------------------------------- the comm


@dataclass(frozen=True)
class HierComm:
    """Two-level hierarchical communicator over a grid of ranks
    (:class:`StackedGrid` or :class:`DistGrid`).

    Binds the static context once: the grid (which names its
    ``inter_axis`` and ``intra_axis``), the round-step ``backend``
    (``"cuda"``: the kernels on a CUDA tensor, their plain versions on a
    CPU one; ``"torch"``: the plain versions) and one
    :class:`~repro_torch.core.costmodel.CommModel` a level.  ``plan``
    precomputes a :class:`HierPlan`; the named collectives are thin
    plan-cache lookups.  Frozen and hashable.
    """

    grid: Any
    backend: str = "cuda"
    inter_model: CommModel = DEFAULT_MODEL
    intra_model: CommModel = DEFAULT_MODEL

    def __post_init__(self):
        if self.inter_axis == self.intra_axis:
            raise ValueError("inter_axis and intra_axis must differ, got "
                             f"{self.inter_axis!r} twice")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown round-step backend {self.backend!r} "
                             f"(use one of {BACKENDS})")

    @property
    def inter_axis(self) -> str:
        return self.grid.inter_axis

    @property
    def intra_axis(self) -> str:
        return self.grid.intra_axis

    @property
    def nodes(self) -> int:
        return self.grid.nodes

    @property
    def cores(self) -> int:
        return self.grid.cores

    @property
    def p(self) -> int:
        return self.nodes * self.cores

    # ------------------------------------------------------------- planning

    def plan(self, kind: str, spec: Any, *,
             n_inter: Optional[int] = None, n_intra: Optional[int] = None,
             root: int = 0, op: str = "sum") -> HierPlan:
        """Precompute a :class:`HierPlan` for ``kind`` and a payload spec.

        ``root`` is the flat node-major rank ``node * cores + core``.
        ``n_inter`` / ``n_intra`` override the per-level cost-model
        optima.  Cached process-wide; equal arguments return the
        identical plan object.
        """
        if kind not in HIER_KINDS:
            raise ValueError(f"unknown hier kind {kind!r} "
                             f"(use one of {HIER_KINDS})")
        kind = _CANONICAL_KIND.get(kind, kind)
        spec = payload_spec(spec)
        _require(spec.num_leaves > 0, "payload has no array leaves")
        rooted = kind in ("broadcast", "reduce", "allreduce")
        reducing = kind in ("reduce", "allreduce")
        _require(rooted or int(root) == 0,
                 f"root= does not apply to hier kind {kind!r}")
        _require(reducing or op == "sum",
                 f"op= does not apply to hier kind {kind!r}")
        _require(0 <= int(root) < self.p,
                 f"root must be in [0, nodes*cores), got {root} for "
                 f"{self.nodes}x{self.cores}")
        root_key = int(root) if rooted else 0
        op_key = op if reducing else None
        nN, nC = self._resolve_n(kind, spec, n_inter, n_intra)
        key = ("hierplan", self.grid, self.backend, self.inter_model,
               self.intra_model, kind, spec, nN, nC, root_key, op_key)
        return traced_plan(key, lambda: self._build(
            kind, spec, nN, nC, root_key, op_key), kind=kind, level="hier")

    def _resolve_n(self, kind: str, spec: PayloadSpec,
                   n_inter: Optional[int],
                   n_intra: Optional[int]) -> Tuple[int, int]:
        if self.p == 1:
            return max(1, n_inter or 1), max(1, n_intra or 1)
        gspec = PayloadSpec(spec.treedef, tuple(
            (self.grid.global_shape(s), d) for s, d in spec.leaves))
        return _resolve_hier_blocks(kind, gspec, self.nodes, self.cores,
                                    n_inter, n_intra, self.inter_model,
                                    self.intra_model)

    def _build(self, kind: str, spec: PayloadSpec, nN: int, nC: int,
               root: int, op: Optional[str]) -> HierPlan:
        nodes, cores = self.nodes, self.cores
        if op is not None:
            _validate(op)
        rN = num_rounds(nodes, nN)
        rC = num_rounds(cores, nC)
        scale = 2 if kind == "allreduce" else 1
        common = dict(kind=kind, spec=spec, nodes=nodes, cores=cores,
                      root=root, op=op, n_inter=nN, n_intra=nC,
                      rounds=scale * (rN + rC), rounds_inter=scale * rN,
                      rounds_intra=scale * rC, backend=self.backend,
                      inter_axis=self.inter_axis, intra_axis=self.intra_axis,
                      grid=self.grid)
        if self.p == 1:
            return HierPlan(_execute=None, **common)
        rootN, rootC = divmod(root, cores)
        bN = get_bundle(nodes, rootN)
        bC = get_bundle(cores, rootC)
        ex, tables = _lower_hier(self.grid, kind, bN, bC, nN, nC, root, op,
                                 get_round_step(self.backend))
        return HierPlan(_execute=ex, device_tables=tables,
                        statics=_hier_statics(kind, bN, bC, nN, nC,
                                              self.inter_axis,
                                              self.intra_axis),
                        **common)

    # ------------------------------------------------ collective shorthands

    def broadcast(self, x: Any, *, n_inter: Optional[int] = None,
                  n_intra: Optional[int] = None, root: int = 0) -> Any:
        """Leader broadcast + intra fan-out of flat rank ``root``'s slices."""
        return self.plan("broadcast", payload_spec(x), n_inter=n_inter,
                         n_intra=n_intra, root=root)(x)

    def reduce(self, x: Any, *, n_inter: Optional[int] = None,
               n_intra: Optional[int] = None, root: int = 0,
               op: str = "sum") -> Any:
        """Intra-reduce to the leaders, then inter-reduce to ``root``."""
        return self.plan("reduce", payload_spec(x), n_inter=n_inter,
                         n_intra=n_intra, root=root, op=op)(x)

    def allreduce(self, x: Any, *, n_inter: Optional[int] = None,
                  n_intra: Optional[int] = None, root: int = 0,
                  op: str = "sum") -> Any:
        """Intra-reduce -> inter-reduce -> inter and intra broadcast."""
        return self.plan("allreduce", payload_spec(x), n_inter=n_inter,
                         n_intra=n_intra, root=root, op=op)(x)

    def allgather(self, x: Any, *, n_inter: Optional[int] = None,
                  n_intra: Optional[int] = None) -> Any:
        """Two-phase all-to-all broadcast; replicated rank-major result."""
        return self.plan("allgather", payload_spec(x), n_inter=n_inter,
                         n_intra=n_intra)(x)


def get_hier_comm(grid: Any, *, backend: str = "cuda",
                  inter_model: CommModel = DEFAULT_MODEL,
                  intra_model: CommModel = DEFAULT_MODEL) -> HierComm:
    """The process-cached :class:`HierComm` for this context (identity is
    stable while cached, like :func:`repro_torch.core.comm.get_comm`)."""
    return cached_plan(
        ("hiercomm", grid, backend, inter_model, intra_model),
        lambda: HierComm(grid=grid, backend=backend,
                         inter_model=inter_model, intra_model=intra_model))


# ------------------------------------------------------ functional wrappers


def hier_broadcast(grid: Any, x: Any, *, n_inter: Optional[int] = None,
                   n_intra: Optional[int] = None, root: int = 0,
                   backend: str = "cuda") -> Any:
    """One-call hierarchical broadcast (plan-cache lookup under the hood)."""
    return get_hier_comm(grid, backend=backend).broadcast(
        x, n_inter=n_inter, n_intra=n_intra, root=root)


def hier_reduce(grid: Any, x: Any, *, n_inter: Optional[int] = None,
                n_intra: Optional[int] = None, root: int = 0, op: str = "sum",
                backend: str = "cuda") -> Any:
    """One-call hierarchical reduction to flat rank ``root``."""
    return get_hier_comm(grid, backend=backend).reduce(
        x, n_inter=n_inter, n_intra=n_intra, root=root, op=op)


def hier_allreduce(grid: Any, x: Any, *, n_inter: Optional[int] = None,
                   n_intra: Optional[int] = None, root: int = 0,
                   op: str = "sum", backend: str = "cuda") -> Any:
    """One-call hierarchical all-reduction."""
    return get_hier_comm(grid, backend=backend).allreduce(
        x, n_inter=n_inter, n_intra=n_intra, root=root, op=op)


def hier_allgather(grid: Any, x: Any, *, n_inter: Optional[int] = None,
                   n_intra: Optional[int] = None, backend: str = "cuda") -> Any:
    """One-call hierarchical allgather (replicated rank-major result)."""
    return get_hier_comm(grid, backend=backend).allgather(
        x, n_inter=n_inter, n_intra=n_intra)


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
