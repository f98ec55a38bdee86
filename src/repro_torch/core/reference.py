"""Legacy-cost schedule constructions used as baselines (paper [12,13,16]).

The PyTorch port's own copy of ``repro.core.reference``: the port imports
nothing of the JAX package, and ``tests/test_torch_reference.py`` holds
the two equal for every rank.

The paper improves schedule computation from O(p log^2 p) [16] and
O(log^3 p) [12,13] per processor down to O(log p).  The original legacy
code is not published in algorithmic form (the paper notes its send-side
improvements "were not documented in [12,13]"), so for the Table-3 style
benchmark we provide *cost-faithful* stand-ins that produce exactly the
same schedules as the new algorithms but with the legacy asymptotic
costs:

  * ``recv_schedule_legacy`` -- O(log^2 p) per processor: recomputes the
    whole DFS prefix for every round k (q restarts of an O(q) search),
    which is precisely the restart structure that the new algorithm's
    shared backtracking state eliminates.
  * ``send_schedule_legacy`` -- O(log^3 p) per processor: the
    "straightforward computation" of §2.4, sendblock[k]_r =
    recvblock[k]_{(r+skip[k]) mod p}, i.e. q legacy receive-schedule
    computations.
  * ``send_schedule_from_recv`` -- the same construction on top of the
    new O(log p) receive schedule: O(log^2 p), matching what the paper
    reports the old implementation actually achieved in practice.

Differential tests assert all of these agree with the O(log p)
algorithms for every processor.
"""

from __future__ import annotations

from typing import List, Sequence

from .schedule import ceil_log2, compute_skips, recv_schedule

__all__ = [
    "recv_schedule_legacy",
    "send_schedule_legacy",
    "send_schedule_from_recv",
]


def recv_schedule_legacy(p: int, r: int, skip: Sequence[int] | None = None) -> List[int]:
    """O(log^2 p) receive schedule via q restarts of the round search.

    For each round k the search is restarted from scratch and run until
    entry k is produced; only that entry is kept.  Identical output to
    :func:`repro_torch.core.schedule.recv_schedule`, with the legacy quadratic
    per-processor cost.
    """
    q = ceil_log2(p)
    if skip is None:
        skip = compute_skips(p)
    if q == 0:
        return []
    out = [0] * q
    for k in range(q):
        # Restart: recompute rounds 0..k and keep round k only.
        full = recv_schedule(p, r, skip)
        out[k] = full[k]
        # (A faithful restart recomputes the prefix; recomputing the whole
        # schedule has the same Theta(q) cost per restart.)
    return out


def send_schedule_from_recv(
    p: int,
    r: int,
    skip: Sequence[int] | None = None,
    recv_fn=recv_schedule,
) -> List[int]:
    """sendblock[k]_r = recvblock[k]_{(r+skip[k]) mod p}.

    The straightforward O(q x recv-cost) send construction that §2.4
    replaces: O(log^2 p) with the new receive algorithm, O(log^3 p) with
    the legacy one.
    """
    q = ceil_log2(p)
    if skip is None:
        skip = compute_skips(p)
    return [recv_fn(p, (r + skip[k]) % p, skip)[k] for k in range(q)]


def send_schedule_legacy(p: int, r: int, skip: Sequence[int] | None = None) -> List[int]:
    """O(log^3 p) send schedule: q legacy receive-schedule computations."""
    return send_schedule_from_recv(p, r, skip, recv_fn=recv_schedule_legacy)
