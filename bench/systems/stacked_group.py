"""``get_comm(StackedGroup(p))``: the flat plan/execute communicator over
p ranks held as rows of one device (the exchange is a roll of those rows).

Configuration keys: ``p``, ``root`` (for the rooted kinds), ``dtype``."""

from __future__ import annotations

from typing import Any, Dict

from bench.harness import system


def build(config: Dict[str, Any], t) -> system.System:
    from repro_torch.core import StackedGroup, get_comm

    return system.planned(get_comm(StackedGroup(t.p, device=t.device)), t, _phases)


def _phases(plan, t):
    """The plan's round loops in run order, each with the slot tables its
    launches index (the plan's own device tables)."""
    p, n, R = plan.p, plan.n_blocks, plan.rounds
    layout = {
        "broadcast": [("forward", R, p, n, 1)],
        # a row for each (rank, root): an allgather's row holds a rank's
        # whole contribution, a reduce_scatter's the part for one root
        "allgather": [("forward", R, p * p, n, 1)],
        "reduce_scatter": [("reduce", R, p * p, n, p)],
        "reduce": [("reduce", R, p, n, 1)],
        "allreduce": [("reduce", R // 2, p, n, 1), ("forward", R // 2, p, n, 1)],
    }.get(plan.kind)
    if layout is None:
        return None
    return system.loops(plan.device_tables, layout, t.leaves)
