"""Allgather: each rank's copy of each leaf equals the whole ``[p, m]``
input.  With the ``per_rank`` entry the result holds every rank's copy
(``[p, p, m]``); with ``call``, one copy (``[p, m]``)."""

import math

from bench.reference import map_leaves, per_leaf, rows_gap


def compare(x, out, t) -> dict:
    def leaf_gap(a, b):
        if t.entry != "per_rank":
            return rows_gap(b[None], a) if tuple(b.shape) == tuple(a.shape) else math.inf
        if tuple(b.shape) != (t.p,) + tuple(a.shape):
            return math.inf
        return rows_gap(b, a)
    return {"max_abs_diff": per_leaf(x, out, leaf_gap)}


def control(x, t, dtype):
    def leaf(a):
        low = a.to(dtype).to(a.dtype)
        return low.expand(t.p, -1, -1) if t.entry == "per_rank" else low
    return map_leaves(leaf, x)
