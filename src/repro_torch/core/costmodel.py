"""Linear (alpha-beta) communication cost models for the paper's collectives.

The PyTorch port's own copy of ``repro.core.costmodel``: the port imports
nothing of the JAX package, and ``tests/test_torch_schedule.py`` holds
the two equal.

Used to (a) choose the number of blocks n for a given message size as in
the paper's experiments (block size F*sqrt(m/ceil(log p)) for broadcast,
n = sqrt(m*ceil(log p))/G blocks for allgatherv), and (b) produce the
simulated Figure-1/2/3 comparisons against classic algorithms (binomial
tree, scatter-allgather, ring, recursive doubling, Bruck).

Model: sending a message of m bytes costs alpha + beta*m; all processors
may send one and receive one message per round (one-ported, fully
bidirectional); rounds are synchronous.  Costs are per the critical path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .schedule import ceil_log2

__all__ = [
    "CommModel",
    "DEFAULT_MODEL",
    "bcast_circulant_cost",
    "bcast_binomial_cost",
    "bcast_scatter_allgather_cost",
    "bcast_linear_pipeline_cost",
    "allgather_circulant_cost",
    "allgather_ring_cost",
    "allgather_bruck_cost",
    "reduce_circulant_cost",
    "reduce_binomial_cost",
    "allreduce_circulant_cost",
    "allreduce_ring_cost",
    "allreduce_recursive_doubling_cost",
    "optimal_num_blocks_bcast",
    "optimal_num_blocks_allgather",
    "optimal_num_blocks_reduce",
    "optimal_num_blocks_allreduce",
    "hier_cost",
    "optimal_hier_blocks",
]


@dataclass(frozen=True)
class CommModel:
    """alpha: per-message latency (s); beta: per-byte time (s/byte).

    Frozen (immutable) and hashable by value, so a model is a valid
    component of process-wide plan-cache keys (repro_torch.core.comm) and the
    shared signature default below is provably never mutated.
    """

    alpha: float = 1e-6
    beta: float = 1.0 / 50e9  # ~50 GB/s link

    def msg(self, nbytes: float) -> float:
        return self.alpha + self.beta * nbytes


#: The one module-level default every collective signature shares.
#: ``CommModel`` is frozen, so exposing a single instance is safe -- and
#: it makes ``model=DEFAULT_MODEL`` calls hit the same plan-cache entry.
DEFAULT_MODEL = CommModel()


def bcast_circulant_cost(p: int, m: float, n: int, model: CommModel) -> float:
    """n-block circulant broadcast: n-1+q rounds of ceil(m/n)-byte messages."""
    if p == 1:
        return 0.0
    q = ceil_log2(p)
    return (n - 1 + q) * model.msg(math.ceil(m / n))


def bcast_binomial_cost(p: int, m: float, model: CommModel) -> float:
    """Binomial tree: q rounds of the full message."""
    if p == 1:
        return 0.0
    return ceil_log2(p) * model.msg(m)


def bcast_scatter_allgather_cost(p: int, m: float, model: CommModel) -> float:
    """Van-de-Geijn: binomial scatter + ring allgather (classic large-m)."""
    if p == 1:
        return 0.0
    q = ceil_log2(p)
    scatter = q * model.alpha + model.beta * m * (p - 1) / p
    allgather = (p - 1) * model.msg(m / p)
    return scatter + allgather


def bcast_linear_pipeline_cost(p: int, m: float, n: int, model: CommModel) -> float:
    """Linear pipeline through a chain: p-1+n-1 rounds of m/n blocks."""
    if p == 1:
        return 0.0
    return (p - 2 + n) * model.msg(math.ceil(m / n))


def allgather_circulant_cost(p: int, m: float, n: int, model: CommModel) -> float:
    """Circulant all-to-all broadcast of per-rank m/p bytes in n blocks.

    Round message: (p-1) blocks of size m/(p*n) -> n-1+q rounds.
    """
    if p == 1:
        return 0.0
    q = ceil_log2(p)
    per_round = (p - 1) * math.ceil(m / (p * n))
    return (n - 1 + q) * model.msg(per_round)


def allgather_ring_cost(p: int, m: float, model: CommModel) -> float:
    """Ring allgather: p-1 rounds of m/p bytes."""
    if p == 1:
        return 0.0
    return (p - 1) * model.msg(m / p)


def allgather_bruck_cost(p: int, m: float, model: CommModel) -> float:
    """Bruck/recursive-doubling allgather: q rounds, doubling volume."""
    if p == 1:
        return 0.0
    q = ceil_log2(p)
    total = 0.0
    have = m / p
    for _ in range(q):
        total += model.msg(min(have, m - have) if have < m else 0)
        have = min(2 * have, m)
    return total


# -------------------------- reversed-schedule family (arXiv:2407.18004)


def reduce_circulant_cost(p: int, m: float, n: int, model: CommModel) -> float:
    """n-block circulant reduction: the time-reversed broadcast, so the
    identical n-1+q rounds of ceil(m/n)-byte messages (reduction work is
    off the critical path in the alpha-beta model)."""
    return bcast_circulant_cost(p, m, n, model)


def reduce_binomial_cost(p: int, m: float, model: CommModel) -> float:
    """Binomial-tree reduction: q rounds of the full message (the
    reversed binomial broadcast)."""
    return bcast_binomial_cost(p, m, model)


def allreduce_circulant_cost(p: int, m: float, n: int, model: CommModel) -> float:
    """Circulant all-reduction: reversed reduce + forward broadcast
    pipelined on the same schedule, 2(n-1)+2q rounds of ceil(m/n)."""
    if p == 1:
        return 0.0
    q = ceil_log2(p)
    return 2 * (n - 1 + q) * model.msg(math.ceil(m / n))


def allreduce_ring_cost(p: int, m: float, model: CommModel) -> float:
    """Ring all-reduce: reduce-scatter + allgather, 2(p-1) rounds of m/p
    (bandwidth-optimal, latency-bound at 2(p-1) messages)."""
    if p == 1:
        return 0.0
    return 2 * (p - 1) * model.msg(m / p)


def allreduce_recursive_doubling_cost(p: int, m: float, model: CommModel) -> float:
    """Recursive-doubling all-reduce: q rounds of the full message."""
    if p == 1:
        return 0.0
    return ceil_log2(p) * model.msg(m)


def _clamp_blocks(n: float, cap: float) -> int:
    """Clamp an analytic block-count optimum to ``[1, floor(cap)]``.

    ``cap`` is the payload unit count blocks must not outnumber (a block
    beyond it is pure padding: it moves no payload but still costs a
    round).  Total: any float ``n``/``cap`` -- including nonfinite or
    huge optima from degenerate models -- satisfies
    ``1 <= result <= max(1, cap)``.
    """
    if not (cap > 1):                        # <=1, zero, negative, NaN
        return 1
    hi = int(cap) if math.isfinite(cap) else (1 << 31)
    if not math.isfinite(n):
        return hi if n > 0 else 1
    return max(1, min(int(round(n)), hi))


def optimal_num_blocks_bcast(p: int, m: float, model: CommModel) -> int:
    """Analytic optimum of (n-1+q)(alpha + beta*m/n) over n.

    d/dn [ (n-1+q) (alpha + beta m / n) ] = 0 gives
    n* = sqrt((q-1) * beta * m / alpha); the paper's practical rule uses
    block size F*sqrt(m/q), i.e. n ~ sqrt(m*q)/F.  We return the analytic
    optimum clamped to [1, m] (never more blocks than payload units --
    block n > m would be pad-only and waste a round).
    """
    if p == 1:
        return 1
    q = ceil_log2(p)
    if not (m > 1):
        return 1
    n = math.sqrt(max(q - 1, 1) * model.beta * m / model.alpha)
    return _clamp_blocks(n, m)


def optimal_num_blocks_reduce(p: int, m: float, model: CommModel) -> int:
    """Analytic optimum for the circulant reduction block count.

    The reversed schedule has the forward round structure, so the
    broadcast optimum n* = sqrt((q-1) beta m / alpha) carries over.
    """
    return optimal_num_blocks_bcast(p, m, model)


def optimal_num_blocks_allreduce(p: int, m: float, model: CommModel) -> int:
    """Analytic optimum for the composed all-reduction.

    Minimizing 2(n-1+q)(alpha + beta m/n) gives the same n* as a single
    phase -- the factor 2 scales the cost, not the argmin.
    """
    return optimal_num_blocks_bcast(p, m, model)


# ----------------------- two-level (hierarchical) cost, paper evaluation
#
# The paper's 36x32 evaluation cluster has an order-of-magnitude gap
# between intra-node and inter-node link costs; a flat circulant
# schedule over p = nodes*cores prices every hop with one (alpha, beta).
# The hierarchical composition (repro_torch.core.hier) runs one circulant
# collective per level, each under its own CommModel, so the two-level
# cost is simply the sum of the per-level single-collective costs --
# and because the levels pipeline nothing into each other, the block
# counts decouple: each level's n* is the flat analytic optimum under
# its own model and message volume.

_HIER_KINDS = ("broadcast", "reduce", "allreduce", "allgather")


def hier_cost(
    kind: str,
    p_inter: int,
    p_intra: int,
    m_inter: float,
    m_intra: float,
    n_inter: int,
    n_intra: int,
    inter_model: CommModel = DEFAULT_MODEL,
    intra_model: CommModel = DEFAULT_MODEL,
) -> float:
    """Two-level cost of a hierarchical circulant collective.

    ``m_inter`` / ``m_intra`` are the bytes each level moves (they can
    differ: a hierarchical allgather's intra level only moves the node's
    share).  Broadcast/reduce compose one phase per level; allreduce
    composes both (reversed reduce + forward broadcast at each level);
    allgather composes the two all-to-all broadcast phases.
    """
    if kind not in _HIER_KINDS:
        raise ValueError(f"unknown hier kind {kind!r} (use one of {_HIER_KINDS})")
    if kind == "allgather":
        inter = allgather_circulant_cost(p_inter, m_inter, n_inter, inter_model)
        intra = allgather_circulant_cost(p_intra, m_intra, n_intra, intra_model)
    else:
        inter = bcast_circulant_cost(p_inter, m_inter, n_inter, inter_model)
        intra = bcast_circulant_cost(p_intra, m_intra, n_intra, intra_model)
    scale = 2.0 if kind == "allreduce" else 1.0
    return scale * (inter + intra)


def optimal_hier_blocks(
    p_inter: int,
    p_intra: int,
    m_inter: float,
    m_intra: float,
    inter_model: CommModel = DEFAULT_MODEL,
    intra_model: CommModel = DEFAULT_MODEL,
    kind: str = "broadcast",
) -> "tuple[int, int]":
    """Per-level optimal block counts ``(n_inter, n_intra)``.

    The two-level cost is separable (no cross-level pipelining), so each
    level takes its flat analytic optimum under its own model: the
    broadcast/reduce/allreduce argmin ``sqrt((q-1) beta m / alpha)`` or
    the allgather variant -- evaluated with the level's own (p, m).
    """
    if kind not in _HIER_KINDS:
        raise ValueError(f"unknown hier kind {kind!r} (use one of {_HIER_KINDS})")
    if kind == "allgather":
        n_inter = optimal_num_blocks_allgather(p_inter, m_inter, inter_model)
        n_intra = optimal_num_blocks_allgather(p_intra, m_intra, intra_model)
    else:
        n_inter = optimal_num_blocks_bcast(p_inter, m_inter, inter_model)
        n_intra = optimal_num_blocks_bcast(p_intra, m_intra, intra_model)
    # Per-level clamp, restated here so the composed result upholds the
    # n <= max(1, m) invariant even if a level optimizer is swapped out.
    return (_clamp_blocks(n_inter, m_inter), _clamp_blocks(n_intra, m_intra))


def optimal_num_blocks_allgather(p: int, m: float, model: CommModel) -> int:
    """Analytic optimum for the circulant allgather block count."""
    if p == 1:
        return 1
    q = ceil_log2(p)
    mb = m * (p - 1) / p  # bytes moved per full sweep
    if not (mb > 1):
        return 1
    n = math.sqrt(max(q - 1, 1) * model.beta * mb / model.alpha)
    return _clamp_blocks(n, m / p)  # blocks split the per-rank share
