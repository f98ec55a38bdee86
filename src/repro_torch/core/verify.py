"""Verification of the schedule correctness conditions, forward and reversed.

The PyTorch port's own copy of ``repro.core.verify``: the port imports
nothing of the JAX package, and ``tests/test_torch_schedule.py`` holds
the two equal.

The forward conditions (paper §2.1) are the unambiguous ground truth for
any schedule construction:

  1. recvblock[k]_r == sendblock[k]_{f_r^k}  (block received is the block
     sent by the from-processor),
  2. sendblock[k]_r == recvblock[k]_{t_r^k}  (equivalent formulation),
  3. over q rounds every processor receives q different blocks:
     union_k recvblock[k] == ({-1..-q} \\ {b-q}) u {b} where b is the
     processor's baseblock (for the root, b = q and all entries negative),
  4. every sent block was received in an earlier round, or is the
     baseblock from the previous phase: sendblock[k] == recvblock[j] for
     some j < k, or sendblock[k] == b - q.

The *reversed* schedules (recv/send roles swapped, directions negated,
rounds replayed t -> R-1-t) drive the reduction / all-reduction of the
follow-up paper (arXiv:2407.18004); their correctness conditions are the
mirror images, stated on the reversed tables:

  * reversed condition 3: over q rounds every non-root *forwards* q
    different partials (its baseblock plus one per foreign phase), so
    nothing is left behind when the reduction finishes;
  * reversed condition 4: every partial *accumulated* in the reversed
    round of column k is forwarded in a reversed-later round (column
    j < k of the same phase) or carried as the baseblock into the next
    reversed phase -- contributions never stall on a non-root.

``verify_schedules`` / ``verify_reversed_schedules`` check every
processor and raise AssertionError with a precise message on the first
failure; ``verify_bundle`` / ``verify_p`` run BOTH directions, so one
call certifies the whole collective family (broadcast, all-broadcast,
reduction, all-reduction).

CLI: ``PYTHONPATH=src python -m repro_torch.core.verify [p ...]`` verifies the
given axis sizes (default: a representative sweep).
"""

from __future__ import annotations

from typing import Sequence

from .schedule import baseblock, ceil_log2, compute_skips

__all__ = [
    "verify_schedules",
    "verify_reversed_schedules",
    "verify_bundle",
    "verify_p",
    "check_condition_3",
    "check_condition_4",
    "check_reversed_condition_3",
    "check_reversed_condition_4",
]


def check_condition_3(recv: Sequence[int], b: int, q: int) -> bool:
    """Condition 3 for one processor with baseblock b."""
    expect = set(range(-q, 0))
    if b < q:  # non-root: b replaces b-q
        expect.discard(b - q)
        expect.add(b)
    # root (b == q): all negative, the full set {-1..-q}
    return set(recv) == expect and len(set(recv)) == q


def check_condition_4(recv: Sequence[int], send: Sequence[int], b: int, q: int) -> bool:
    """Condition 4 for one (non-root) processor with baseblock b."""
    if send and send[0] != b - q:
        return False
    for k in range(q):
        if send[k] == b - q:
            continue
        if not any(send[k] == recv[j] for j in range(k)):
            return False
    return True


def verify_schedules(
    p: int,
    recv: Sequence[Sequence[int]],
    send: Sequence[Sequence[int]],
) -> None:
    """Check all four correctness conditions for all p processors."""
    q = ceil_log2(p)
    skip = compute_skips(p)
    for r in range(p):
        b = baseblock(r, skip, q)
        # Condition 3
        assert check_condition_3(recv[r], b, q), (
            f"cond3 failed p={p} r={r}: recv={list(recv[r])} b={b}"
        )
        for k in range(q):
            t = (r + skip[k]) % p
            f = (r - skip[k] + p) % p
            # Conditions 1 & 2 (equivalent; check both directions)
            assert send[r][k] == recv[t][k], (
                f"cond2 failed p={p} r={r} k={k}: send={send[r][k]} "
                f"recv[t={t}]={recv[t][k]}"
            )
            assert recv[r][k] == send[f][k], (
                f"cond1 failed p={p} r={r} k={k}: recv={recv[r][k]} "
                f"send[f={f}]={send[f][k]}"
            )
        # Condition 4 (non-root only; the root sends blocks 0..q-1)
        if r == 0:
            assert list(send[r]) == list(range(q)), (
                f"root send schedule must be 0..q-1, got {list(send[r])}"
            )
        else:
            assert check_condition_4(recv[r], send[r], b, q), (
                f"cond4 failed p={p} r={r}: recv={list(recv[r])} "
                f"send={list(send[r])} b={b}"
            )


def check_reversed_condition_3(send_rev: Sequence[int], b: int, q: int) -> bool:
    """Reversed condition 3 for one processor with baseblock b.

    Over the q reversed rounds the processor forwards q *distinct*
    partials: its own baseblock b plus one block per foreign phase
    ({-q..-1} \\ {b-q}); the root (b == q) forwards only phase-carried
    negatives.  Stated on the reversed send table (== forward recv), so
    the set condition mirrors the forward condition 3.
    """
    expect = set(range(-q, 0))
    if b < q:  # non-root: the own baseblock replaces b-q
        expect.discard(b - q)
        expect.add(b)
    return set(send_rev) == expect and len(set(send_rev)) == q


def check_reversed_condition_4(
    recv_rev: Sequence[int], send_rev: Sequence[int], b: int, q: int
) -> bool:
    """Reversed condition 4 for one (non-root) processor with baseblock b.

    Reduction rounds replay forward rounds backwards (t -> R-1-t), so
    "forwarded at a reversed-later round" means a *smaller* forward
    column index: every partial accumulated in column k must be forwarded
    in some column j < k (recv_rev[k] == send_rev[j]), or be the
    baseblock handed to the next reversed phase (recv_rev[k] == b - q,
    forwarded as b one phase later).  The processor's very first
    accumulation (k = 0 side) must be the phase-carried baseblock.
    """
    if recv_rev and recv_rev[0] != b - q:
        return False
    for k in range(q):
        if recv_rev[k] == b - q:
            continue
        if not any(recv_rev[k] == send_rev[j] for j in range(k)):
            return False
    return True


def verify_reversed_schedules(
    p: int,
    recv_rev: Sequence[Sequence[int]],
    send_rev: Sequence[Sequence[int]],
) -> None:
    """Check the reversed correctness conditions for all p processors.

    ``recv_rev[r][k]`` is the block rank r accumulates and
    ``send_rev[r][k]`` the partial it forwards in the reversed round of
    column k; partials travel *against* the circulant edges, so rank r
    forwards to (r - skip[k]) % p and accumulates from (r + skip[k]) % p.
    """
    q = ceil_log2(p)
    skip = compute_skips(p)
    for r in range(p):
        b = baseblock(r, skip, q)
        # Reversed condition 3: everything a rank ever holds is forwarded.
        assert check_reversed_condition_3(send_rev[r], b, q), (
            f"rev-cond3 failed p={p} r={r}: send_rev={list(send_rev[r])} b={b}"
        )
        for k in range(q):
            t = (r + skip[k]) % p   # reversed from-processor of r
            f = (r - skip[k]) % p   # reversed to-processor of r
            # Reversed conditions 1 & 2: what r forwards along the flipped
            # edge is exactly what its reversed to-processor accumulates.
            assert send_rev[r][k] == recv_rev[f][k], (
                f"rev-cond2 failed p={p} r={r} k={k}: send_rev={send_rev[r][k]} "
                f"recv_rev[f={f}]={recv_rev[f][k]}"
            )
            assert recv_rev[r][k] == send_rev[t][k], (
                f"rev-cond1 failed p={p} r={r} k={k}: recv_rev={recv_rev[r][k]} "
                f"send_rev[t={t}]={send_rev[t][k]}"
            )
        # Reversed condition 4 (the root only accumulates; its recv_rev row
        # is the forward root send row 0..q-1, nothing to forward).
        if r == 0:
            assert list(recv_rev[r]) == list(range(q)), (
                f"root accumulation schedule must be 0..q-1, got {list(recv_rev[r])}"
            )
        else:
            assert check_reversed_condition_4(recv_rev[r], send_rev[r], b, q), (
                f"rev-cond4 failed p={p} r={r}: recv_rev={list(recv_rev[r])} "
                f"send_rev={list(send_rev[r])} b={b}"
            )


def verify_bundle(bundle) -> None:
    """Verify a :class:`repro_torch.core.engine.ScheduleBundle` (any root).

    Bundle rows are indexed by real rank with the root relabeling folded
    in; the conditions are stated in virtual numbering, so un-rotate the
    rows (virtual rank v is real rank (v + root) mod p) and check both
    the forward (broadcast) and reversed (reduction) tables -- one call
    certifies the whole collective family.
    """
    p, root = bundle.p, bundle.root
    recv = [bundle.recv_row((v + root) % p) for v in range(p)]
    send = [bundle.send_row((v + root) % p) for v in range(p)]
    verify_schedules(p, recv, send)
    # The reversed tables are the forward ones with roles swapped
    # (rev_recv is send, rev_send is recv), so the row lists above serve
    # both directions -- no second O(p q) construction.
    verify_reversed_schedules(p, recv_rev=send, send_rev=recv)


def verify_p(p: int) -> None:
    """Compute schedules through the cached engine and verify the family
    (forward broadcast conditions + reversed reduction conditions)."""
    from .engine import get_bundle

    verify_bundle(get_bundle(p))


if __name__ == "__main__":  # pragma: no cover - command-line entry point
    import sys

    _ps = [int(a) for a in sys.argv[1:]] or (
        list(range(1, 130)) + [255, 256, 511, 512, 1023, 1024, 8191, 65536]
    )
    for _p in _ps:
        verify_p(_p)
    print(f"verified forward+reversed schedules for {len(_ps)} values of p "
          f"(max {max(_ps)})")
