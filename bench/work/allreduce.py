"""The work a sum allreduce's semantics need: p contributions of M bytes
read once, p sums written once (2 * p * M), and (p - 1) additions an
element, summed over the leaves."""


def work(t) -> dict:
    return {"bytes": sum(2 * t.p * leaf.bytes_per_rank for leaf in t.leaves),
            "flops": sum((t.p - 1) * leaf.elements for leaf in t.leaves)}
