"""Broadcast: every rank's row of each leaf equals the root's input row."""

import math

from bench.reference import map_leaves, per_leaf, rows_gap


def compare(x, out, t) -> dict:
    def leaf_gap(a, b):
        if tuple(b.shape) != tuple(a.shape):
            return math.inf
        return rows_gap(b, a[t.root])
    return {"max_abs_diff": per_leaf(x, out, leaf_gap)}


def control(x, t, dtype):
    return map_leaves(lambda a: a[t.root].to(dtype).to(a.dtype).expand(t.p, -1), x)
