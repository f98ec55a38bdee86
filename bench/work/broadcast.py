"""The work a broadcast's semantics need, whatever implements it: the
root's M bytes read once and p copies of them written once (p * M),
summed over the leaves."""


def work(t) -> dict:
    m = sum(leaf.bytes_per_rank for leaf in t.leaves)
    return {"bytes": m + t.p * m, "flops": 0}
