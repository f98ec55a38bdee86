"""The work an allgather's semantics need: p contributions of m bytes read
once, and every rank's copy of all p of them written once (p * m + p^2 * m),
summed over the leaves."""


def work(t) -> dict:
    m = sum(leaf.bytes_per_rank for leaf in t.leaves)
    return {"bytes": t.p * m + t.p * t.p * m, "flops": 0}
