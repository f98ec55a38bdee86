"""``get_hier_comm(StackedGrid(nodes, cores))``: the two-level
communicator over ``nodes x cores`` ranks held as rows of one device (each
level's exchange is a roll of those rows along its axis), the levels' block
counts from the port's own choice.

Configuration keys: ``nodes``, ``cores``, ``root`` (flat rank
``node * cores + core``, for the rooted kinds), ``dtype``."""

from __future__ import annotations

from typing import Any, Dict

from bench.harness import system


def build(config: Dict[str, Any], t) -> system.System:
    from repro_torch.core.hier import StackedGrid, get_hier_comm

    grid = StackedGrid(int(config["nodes"]), int(config["cores"]), device=t.device)
    return system.planned(get_hier_comm(grid), t, _phases)


def _phases(plan, t):
    """The levels' round loops in run order (inter before intra for a
    broadcast; intra, inter reductions, then the broadcasts for an
    allreduce), each with its level's block count."""
    if plan.nodes == 1 or plan.cores == 1:
        return None
    p = plan.p
    half = 2 if plan.kind == "allreduce" else 1
    inter = (plan.rounds_inter // half, p, plan.n_inter, 1)
    intra = (plan.rounds_intra // half, p, plan.n_intra, 1)
    layout = {
        "broadcast": [("forward",) + inter, ("forward",) + intra],
        "reduce": [("reduce",) + intra, ("reduce",) + inter],
        "allreduce": [("reduce",) + intra, ("reduce",) + inter,
                      ("forward",) + inter, ("forward",) + intra],
    }.get(plan.kind)
    if layout is None:
        return None
    return system.loops(plan.device_tables, layout, t.leaves)
