"""Sum allreduce: every rank's row of each leaf equals the sum of all
input rows, summed here in float64 (integer inputs within a bound make
every float32 order of summation exact, so the program must match it)."""

import math

import torch

from bench.reference import column_sum, map_leaves, per_leaf, rows_gap, rows_per_block


def compare(x, out, t) -> dict:
    def leaf_gap(a, b):
        if tuple(b.shape) != tuple(a.shape):
            return math.inf
        return rows_gap(b, column_sum(a))
    return {"max_abs_diff": per_leaf(x, out, leaf_gap)}


def control(x, t, dtype):
    def leaf(a):
        total = torch.zeros(a.shape[1:], dtype=dtype, device=a.device)
        step = rows_per_block(a.shape[1])
        for i in range(0, a.shape[0], step):
            total += a[i:i + step].to(dtype).sum(0, dtype=dtype)
        return total.to(a.dtype).expand(t.p, -1)
    return map_leaves(leaf, x)
