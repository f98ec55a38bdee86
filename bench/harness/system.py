"""The system under test as the harness holds it, and the round loops of a
plan as the work files read them."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import files, traffic


@dataclass
class System:
    """``call(payload)`` is the timed entry; ``plan`` the object it belongs
    to; ``plan_build_s`` the host seconds of the plan's first build;
    ``phases()`` the plan's round loops (None where the system module does
    not list them)."""

    call: Callable[[Any], Any]
    plan: Any
    plan_build_s: float
    describe: str
    phases: Callable[[], Optional[List[Dict[str, Any]]]]


def build(config: Dict[str, Any], t: traffic.Traffic) -> System:
    """Build the configuration's system (``systems/<system>.py``) for the
    traffic's collective over its payload."""
    return files.module("systems", config["system"]).build(config, t)


def planned(comm, t: traffic.Traffic,
            phases: Callable[[Any, traffic.Traffic], Optional[List[Dict[str, Any]]]]
            ) -> System:
    """The plan of ``comm`` (a communicator with ``plan(kind, payload,
    **kw)``) for the traffic, timed on the host, and its timed entry:
    ``plan(payload)``, or ``plan.per_rank(payload)``.  ``phases(plan, t)``
    lists the plan's round loops."""
    t0 = time.perf_counter()
    plan = comm.plan(t.collective, t.payload, **t.plan_args())
    build_s = time.perf_counter() - t0
    call = plan.per_rank if t.entry == "per_rank" else plan
    return System(call=call, plan=plan, plan_build_s=build_s,
                  describe=plan.describe(), phases=lambda: phases(plan, t))


def _table(table, rounds: int, rows: int, garbage: bool, what: str) -> np.ndarray:
    """A plan's slot table as the host array its device tensor holds,
    checked against the loop it is read for: ``rounds`` rounds (one more,
    the garbage slot's, for a reduction's forward table) of ``rows``
    rows.  A table laid out otherwise raises rather than be miscounted."""
    shape = (rounds + int(garbage), rows)
    got = tuple(table.tensor.shape)
    if got != shape or (getattr(table, "garbage", None) is not None) != garbage:
        raise RuntimeError(
            f"{what}: the plan's slot table is {got} (garbage slot "
            f"{getattr(table, 'garbage', None)}), the loop reads {shape}"
            f"{' with a garbage slot' if garbage else ''}: the plan's tables "
            "changed layout, and systems/ has to follow")
    return np.asarray(table.tensor.cpu())


def forward_phase(recv, send, rounds: int, rows: int, bs: int,
                  itemsize: int) -> Dict[str, Any]:
    """A broadcast-direction round loop: a pack of ``send[0]``, then round
    t's shuffle into ``recv[t]`` and out of ``send[t + 1]``, the last
    round an unpack into ``recv[R - 1]``.  ``rows`` rows a launch, blocks
    of ``bs`` elements of ``itemsize`` bytes."""
    return {"loop": "forward", "rows": rows, "bs": int(bs), "itemsize": itemsize,
            "recv": _table(recv, rounds, rows, False, "forward recv"),
            "send": _table(send, rounds, rows, False, "forward send")}


def reduce_phase(fwd, acc, rounds: int, rows: int, bs: int,
                 itemsize: int) -> Dict[str, Any]:
    """A reduction round loop: the first capture (accumulate into the
    garbage slot ``fwd[R]``, forward ``fwd[0]``), then round t's
    accumulate into ``acc[t]`` and forward out of ``fwd[t + 1]``."""
    return {"loop": "reduce", "rows": rows, "bs": int(bs), "itemsize": itemsize,
            "fwd": _table(fwd, rounds, rows, True, "reduce fwd"),
            "acc": _table(acc, rounds, rows, False, "reduce acc")}


def loops(tables, layout, leaves) -> List[Dict[str, Any]]:
    """The round loops of a plan whose ``tables`` follow ``layout``: one
    ``(loop, rounds, rows, blocks, parts)`` a pair of tables, in run order
    (loop ``forward`` or ``reduce``; a rank's elements fall into ``parts``
    rows of ``blocks`` blocks each), for each leaf."""
    if len(tables) != 2 * len(layout):
        raise RuntimeError(f"the plan has {len(tables)} slot tables, its loops "
                           f"read {2 * len(layout)}: systems/ has to follow")
    make = {"forward": forward_phase, "reduce": reduce_phase}
    return [make[loop](tables[2 * i], tables[2 * i + 1], rounds, rows,
                       -(-leaf.elements // parts // blocks), leaf.itemsize)
            for leaf in leaves
            for i, (loop, rounds, rows, blocks, parts) in enumerate(layout)]
