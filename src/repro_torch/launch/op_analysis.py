"""Op-level cost counting of a traced call: FLOPs, bytes, live memory and
collective traffic.

Port of ``repro.launch.hlo_analysis`` for a package with no HLO.  Where
the reference parses a compiled module, this counts the aten ops that a
call dispatches, under one ``TorchDispatchMode``
(:class:`OpCounter`), on ``meta`` tensors (shapes only, no storage: the
dry run) or on real ones, by the reference's rules:

  * **FLOPs**: matrix products only, as the reference counts ``dot``
    only (elementwise work is noise at model scale): ``mm``, ``addmm``,
    ``bmm``, ``baddbmm`` and the convolutions, by
    ``torch.utils.flop_counter``'s formulas (2 x the output elements x
    the contracted length).
  * **bytes**: 2 x the result bytes of every op that allocates its
    output (one write and an amortised read).  Views and aliases count
    nothing; ``empty`` and its kin write nothing and count nothing.  An
    in-place or ``out=`` op counts its update: the source of an indexed
    update (``index_put_``, ``scatter_``, ``index_add_``, ...: the
    reference's ``scatter``), else the tensor it writes, which is the
    slice's view when a slice is written (the reference's
    ``dynamic-update-slice``).

The rules are the reference's; the numbers are eager torch's.  FLOPs
agree with the reference's count of its compiled forward to the FLOP,
but bytes are not expected to equal XLA's: XLA fuses elementwise chains
into one materialised buffer where eager torch writes each op's result.

A loop body can be counted once and multiplied by its trips, as the
reference's ``_trip_count`` does: :meth:`OpCounter.repeat`.  The counter
also keeps the live bytes of the storages its ops allocated (freed
through ``weakref.finalize`` when the last tensor on them goes) and
their peak: the dry run's ``temp_bytes``.

:func:`collective_stats` counts the exchanges of the port's own
collectives (:mod:`repro_torch.core.comm`'s groups) during a call: each
message of a round is one ``collective-permute`` of its bytes per rank.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCounter", "weighted_cost", "CollectiveStats", "collective_stats"]

_aten = torch.ops.aten

#: The products whose FLOPs count (the reference's ``dot``), by packet.
PRODUCTS = {op: flop_registry[op] for op in (
    _aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution,
    _aten._convolution, _aten.convolution_backward)}

#: Ops that allocate and write nothing.
_NO_WRITE = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.new_empty, _aten.new_empty_strided}

#: In-place updates through an index: the source they write, by
#: argument name (the reference's ``scatter`` rule).
_INDEXED = {"index_put_", "_index_put_impl_", "scatter_",
            "scatter_add_", "scatter_reduce_", "index_add_", "index_copy_",
            "masked_scatter_"}
_SOURCES = ("values", "src", "source")


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (nested in lists,
    tuples and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _mutated(func) -> tuple:
    """The names of the arguments ``func`` writes (cached per overload)."""
    names = _MUTATED.get(func)
    if names is None:
        names = _MUTATED[func] = tuple(
            a.name for a in func._schema.arguments
            if a.alias_info is not None and a.alias_info.is_write)
    return names


_MUTATED: Dict[Any, tuple] = {}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (``with OpCounter() as
    c: ...``): ``flops`` and ``bytes`` by the reference's rules (above),
    ``ops`` the ops seen, ``live_bytes`` and ``peak_bytes`` of the
    storages its ops allocated."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._scale = 1
        self._live: Dict[int, int] = {}

    @contextlib.contextmanager
    def repeat(self, times: int) -> Iterator["OpCounter"]:
        """Count what runs inside ``times`` over: a loop body traced once
        for all its trips.  Memory is not multiplied."""
        outer = self._scale
        self._scale = outer * int(times)
        try:
            yield self
        finally:
            self._scale = outer

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live:
            return
        size = storage.nbytes()
        self._live[key] = size
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def _written(self, func, args, kwargs, outs, in_storages) -> int:
        """The bytes this op writes (before the factor of 2)."""
        mutated = _mutated(func)
        if mutated:
            named = dict(zip((a.name for a in func._schema.arguments), args))
            named.update(kwargs)
            if func._overloadpacket.__name__ in _INDEXED:
                for name in _SOURCES:
                    if isinstance(named.get(name), torch.Tensor):
                        return _nbytes(named[name])
            return sum(_nbytes(t) for name in mutated for t in _tensors(named.get(name)))
        if func._overloadpacket in _NO_WRITE:
            return 0
        return sum(_nbytes(t) for t in outs
                   if t.untyped_storage()._cdata not in in_storages)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = PRODUCTS.get(func._overloadpacket)
        if formula is not None:
            self.flops += self._scale * int(formula(*args, **kwargs, out_val=out))
        in_storages = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        outs = _tensors(out)
        self.bytes += self._scale * 2 * self._written(func, args, kwargs, outs,
                                                      in_storages)
        for t in outs:
            if t.untyped_storage()._cdata not in in_storages:
                self._track(t)
        return out


def weighted_cost(fn: Callable, *args, **kw) -> Dict[str, float]:
    """Run ``fn(*args, **kw)`` under an :class:`OpCounter` ->
    ``{"flops_weighted", "bytes_weighted"}`` of the whole call (the
    reference's keys; divide by the device count for a per-device
    figure, as the dry run does)."""
    with OpCounter() as c:
        fn(*args, **kw)
    return {"flops_weighted": float(c.flops), "bytes_weighted": float(c.bytes)}


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    ops_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_rounds(self) -> int:
        return sum(self.ops_by_kind.values())

    def as_dict(self):
        return {
            "collective_bytes": self.total_bytes,
            "collective_rounds": self.total_rounds,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "ops_by_kind": dict(self.ops_by_kind),
        }


def collective_stats(fn: Callable, *args, **kw) -> CollectiveStats:
    """The exchanges ``fn(*args, **kw)`` makes through the port's groups
    (:class:`~repro_torch.core.comm.StackedGroup`,
    :class:`~repro_torch.core.comm.DistGroup`, a
    :class:`~repro_torch.core.hier.StackedGrid`'s levels): each non-empty
    message of a round is one ``collective-permute`` of its bytes per
    rank (a stacked message's bytes over the rows it holds), as each
    array of the reference's ``ppermute`` is one op of its shard's
    bytes."""
    from ..core import comm

    by_kind: Dict[str, int] = defaultdict(int)
    ops: Dict[str, int] = defaultdict(int)

    def note(level: Any, msgs) -> None:
        rows = len(level.ranks)
        for m in msgs:
            if m.numel():
                by_kind["collective-permute"] += _nbytes(m) // rows
                ops["collective-permute"] += 1

    comm.EXCHANGE_OBSERVERS.append(note)
    try:
        fn(*args, **kw)
    finally:
        comm.EXCHANGE_OBSERVERS.remove(note)
    return CollectiveStats(dict(by_kind), dict(ops))
