"""Round-optimal n-block broadcast schedules in O(log p) time.

The PyTorch port's own copy of ``repro.core.schedule``: the port imports
nothing of the JAX package, and ``tests/test_torch_schedule.py`` holds
the two equal.

Faithful implementation of:

    Jesper Larsson Träff, "Round-optimal n-Block Broadcast Schedules in
    Logarithmic Time", 2023 (arXiv:2312.11236).

The paper gives O(log p)-per-processor algorithms for computing the
receive and send schedules that drive a round-optimal (n-1+ceil(log2 p)
communication rounds) broadcast of n indivisible blocks on a
ceil(log2 p)-regular circulant graph over p processors, and the
corresponding all-to-all broadcast (irregular allgather).

Algorithm numbering follows the paper:

  * Algorithm 3 -> :func:`compute_skips`
  * Algorithm 4 -> :func:`baseblock`
  * Algorithm 5 -> ``_dfs_blocks`` (inner backtracking search)
  * Algorithm 6 -> :func:`recv_schedule`
  * Algorithm 7/8/9 -> :func:`send_schedule`

All functions are pure Python on ints; they are host-side trace-time
computations (a schedule is O(log p) ints), never run on the device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

__all__ = [
    "ceil_log2",
    "compute_skips",
    "baseblock",
    "recv_schedule",
    "send_schedule",
    "schedule_tables",
    "num_rounds",
    "virtual_rounds",
]


def ceil_log2(p: int) -> int:
    """q = ceil(log2 p) for p >= 1."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    return (p - 1).bit_length()


@lru_cache(maxsize=None)
def compute_skips(p: int) -> Tuple[int, ...]:
    """Algorithm 3: skips (jumps) of the p-processor circulant graph.

    Returns a tuple of length q+1 with skip[q] = p and
    skip[k] = ceil(skip[k+1] / 2) for k = q-1 .. 0.  For all p >= 2 this
    ends with skip[0] = 1 and skip[1] = 2 (Observation 2 ff.).
    """
    q = ceil_log2(p)
    skip = [0] * (q + 1)
    skip[q] = p
    for k in range(q - 1, -1, -1):
        skip[k] = skip[k + 1] - skip[k + 1] // 2  # = ceil(skip[k+1]/2)
    return tuple(skip)


def baseblock(r: int, skip: Sequence[int], q: int) -> int:
    """Algorithm 4: smallest skip index of the canonical skip sequence of r.

    The canonical skip sequence is the greedy largest-skip-first
    decomposition of r into a sum of distinct skips (Lemma 1).  The
    baseblock is the first (smallest) index in that sequence; by
    convention the root r=0 has baseblock q (empty sequence).
    """
    k = q
    while k > 0:
        k -= 1
        if skip[k] == r:
            return k
        if skip[k] < r:
            r -= skip[k]
    return q


def _dfs_blocks(
    r: int,
    rp: int,
    s_cell: List[int],
    e: int,
    k: int,
    recvblock: List[int],
    skip: Sequence[int],
    nxt: List[int],
    prv: List[int],
    q: int,
    stats: List[int] | None = None,
) -> int:
    """Algorithm 5: greedy backtracking DFS with removal of accepted blocks.

    ``r`` is the (virtual) target processor p + rank, ``rp`` the current
    path sum r', ``s_cell`` a one-element list holding the shared state s
    (sum of the skips on the most recently accepted path), ``e`` the skip
    index to start scanning from, ``k`` the next round to fill.

    ``nxt``/``prv`` implement the doubly linked list of remaining skip
    indices in decreasing order; index q+1 slots are offset by +1 so the
    sentinel -1 maps to slot 0 (we simply index with e+1).

    Returns the updated k.  ``stats`` (if given) counts recursive calls,
    for validating Proposition 1 (at most 2q calls).
    """
    # Entry guard r' <= r - skip[k+1]; for k >= q treat skip[q+1] as +inf
    # (the guard then fails and the call is a no-op).
    if k + 1 > q or rp > r - skip[k + 1]:
        return k
    while e != -1:
        if k <= q and rp + skip[e] <= r - skip[k]:  # e admissible for k
            if stats is not None:
                stats[0] += 1
            k = _dfs_blocks(
                r, rp + skip[e], s_cell, e, k, recvblock, skip, nxt, prv, q, stats
            )
            # Even if k changed, admissibility still holds; accept e if the
            # path is canonical (dedup against most recently accepted sum s).
            if (k + 1 <= q and rp <= r - skip[k + 1]) and s_cell[0] > rp + skip[e]:
                s_cell[0] = rp + skip[e]
                recvblock[k] = e
                k += 1
                # remove e by unlinking (slot layout: index x lives at slot x+1)
                pe, ne = prv[e + 1], nxt[e + 1]
                nxt[pe + 1] = ne
                prv[ne + 1] = pe
        e = nxt[e + 1]  # values stored are actual indices (-1 = sentinel)
    return k


def recv_schedule(
    p: int,
    r: int,
    skip: Sequence[int] | None = None,
    stats: List[int] | None = None,
) -> List[int]:
    """Algorithm 6: receive schedule for processor r among p.

    Returns recvblock[0..q-1] with exactly one non-negative entry, the
    baseblock b of r (for the root r=0 all entries are negative), and the
    other entries forming {-1,...,-q} \\ {b-q} (Correctness Condition 3).
    Runs in O(log p) operations (Proposition 1).
    """
    q = ceil_log2(p)
    if skip is None:
        skip = compute_skips(p)
    if q == 0:
        return []
    # Doubly linked list over skip indices q..0, decreasing, with sentinel -1.
    # Slot layout: index e lives at slot e+1; sentinel -1 at slot 0.
    nxt = [0] * (q + 2)
    prv = [0] * (q + 2)
    for e in range(q + 1):
        nxt[e + 1] = e - 1
        prv[e + 1] = e + 1
    prv[q + 1] = -1
    nxt[0] = q  # next[-1] = q (head of the decreasing list)
    prv[0] = 0  # prev[-1] = 0 (tail)

    b = baseblock(r, skip, q)
    # Remove baseblock index b by unlinking.
    nxt[prv[b + 1] + 1] = nxt[b + 1]
    prv[nxt[b + 1] + 1] = prv[b + 1]

    recvblock = [0] * q
    s_cell = [p + p]
    _dfs_blocks(p + r, 0, s_cell, q, 0, recvblock, skip, nxt, prv, q, stats)

    for k in range(q):
        if recvblock[k] == q:
            recvblock[k] = b
        else:
            recvblock[k] -= q
    return recvblock


def send_schedule(
    p: int,
    r: int,
    skip: Sequence[int] | None = None,
    violations: List[int] | None = None,
) -> List[int]:
    """Algorithms 7/8/9: send schedule for processor r among p in O(log p).

    Satisfies sendblock[k]_r == recvblock[k]_{(r+skip[k]) mod p} for all
    rounds k (Proposition 4).  At most a constant number (<= 4) of
    "violations" fall back to a recv-schedule computation for the
    to-processor (Proposition 3); ``violations`` (if given) counts them.
    """
    q = ceil_log2(p)
    if skip is None:
        skip = compute_skips(p)
    if q == 0:
        return []
    sendblock = [0] * q
    if r == 0:
        for k in range(q):
            sendblock[k] = k
        return sendblock

    def _violation(k: int) -> int:
        if violations is not None:
            violations[0] += 1
        return recv_schedule(p, (r + skip[k]) % p, skip)[k]

    b = baseblock(r, skip, q)
    rp, c, e = r, b, p
    for k in range(q - 1, 0, -1):
        if rp < skip[k]:
            # ---- lower part (Algorithm 8) ----
            # NOTE: strict "<" as in the paper's pseudocode (the prose says
            # "<="; exhaustive verification shows strict is the correct one,
            # e.g. p=33, r=31, k=2 needs the Violation-(1) fallback).
            if e < skip[k - 1] or (k == 1 and b > 0):
                sendblock[k] = c
            elif rp == 0 and k == 2:
                if e == 2 and skip[2] == 3:
                    sendblock[k] = _violation(k)  # Violation (1)
                else:
                    sendblock[k] = c
            elif rp == 0 and skip[k] == 5:  # implies k == 3
                if e == 3:
                    sendblock[k] = _violation(k)  # Violation (1)
                else:
                    sendblock[k] = c
            elif rp + skip[k] >= e:
                sendblock[k] = _violation(k)  # Violation (2)
            else:
                sendblock[k] = c
            if e > skip[k]:
                e = skip[k]
        else:
            # ---- upper part (Algorithm 9) ----
            c = k - q
            if k == 1 or rp > skip[k] or e - skip[k] < skip[k - 1]:
                sendblock[k] = c
            elif k == 2:
                if skip[2] == 3 and e == 5:
                    sendblock[k] = _violation(k)  # Violation (1)
                else:
                    sendblock[k] = c
            elif skip[k] == 5:  # implies k == 3
                if e == 8:
                    sendblock[k] = _violation(k)  # Violation (1)
                else:
                    sendblock[k] = c
            elif rp + skip[k] > e:
                sendblock[k] = _violation(k)  # Violation (3)
            else:
                sendblock[k] = c
            rp, e = rp - skip[k], e - skip[k]
    sendblock[0] = b - q
    return sendblock


def schedule_tables(p: int):
    """All-ranks schedule tables as lists of lists: (recv[p][q], send[p][q]).

    Convenience for building all-rank tables in one call; per-rank cost
    stays O(log p), total O(p log p).
    """
    skip = compute_skips(p)
    recv = [recv_schedule(p, r, skip) for r in range(p)]
    send = [send_schedule(p, r, skip) for r in range(p)]
    return recv, send


def num_rounds(p: int, n: int) -> int:
    """Optimal number of communication rounds: n - 1 + ceil(log2 p).

    For p == 1 no communication happens at all, so 0.
    """
    if p == 1:
        return 0
    return n - 1 + ceil_log2(p)


def virtual_rounds(p: int, n: int) -> int:
    """x: number of initial virtual rounds so that n-1+q+x is a multiple of q."""
    q = ceil_log2(p)
    if q == 0:
        return 0
    return (q - (n - 1 + q) % q) % q
