"""Round-based message-passing simulator of the collective family.

Port of ``repro.core.simulator`` (``SimResult``, ``simulate_broadcast``,
``simulate_allgather``, ``simulate_allbroadcast``, ``simulate_reduce``,
``simulate_allreduce``).  Executes the paper's broadcast and all-to-all
broadcast algorithms -- and, via the time-reversed schedules, the
derived reduction and all-reduction -- over a simulated
fully-connected, one-ported, bidirectional network in plain Python and
checks that each completes in exactly its optimal round count (n-1+q,
or 2(n-1)+2q for the composed all-reduction) with every block where it
belongs.  It is the end-to-end functional oracle for the schedules.

Backend certification: ``backend="torch"`` or ``backend="cuda"``
additionally executes the collective's *data plane* -- the round steps
of :mod:`repro_torch.core.roundstep` on a device, through the cached
host plans of :func:`repro_torch.core.comm.host_plan` -- and asserts
that its final buffers match the message-passing reference bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .engine import get_bundle
from .schedule import num_rounds

__all__ = [
    "simulate_broadcast",
    "simulate_allgather",
    "simulate_allbroadcast",
    "simulate_reduce",
    "simulate_allreduce",
    "SimResult",
]

# Reduction operators: name -> (binary combine on numpy values).  Both are
# associative and commutative; the reversal delivers every contribution
# exactly once, so '+' is bit-exact and 'max' trivially so.
_OPS = {
    "+": np.add,
    "sum": np.add,
    "max": np.maximum,
}


@dataclass
class SimResult:
    rounds: int                      # actual communication rounds executed
    optimal_rounds: int              # n - 1 + ceil(log2 p)
    messages: int = 0                # point-to-point messages sent
    blocks_moved: int = 0            # total blocks transferred
    buffers: Optional[list] = None   # final per-processor buffers
    backend: Optional[str] = None    # data-plane backend certified (or None)


def simulate_broadcast(
    p: int,
    n: int,
    root: int = 0,
    keep_buffers: bool = False,
    payloads: Optional[List] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> SimResult:
    """Algorithm 1: broadcast n blocks from ``root`` to all p processors.

    Simulates all rounds; asserts the final state is complete.  Block
    payloads default to the block index (so content errors are caught,
    not just counts); ``payloads`` substitutes real per-block values,
    delivered and checked verbatim.  The rooted engine bundle indexes
    schedules by real rank.

    ``backend`` ("torch" / "cuda") additionally executes the round-step
    data plane on ``device`` (``None`` means ``"cuda"``) and asserts
    bit-exact agreement with this reference on every rank.
    """
    pay = list(payloads) if payloads is not None else list(range(n))
    assert len(pay) == n
    # buffer[r][j] holds the payload of block j at processor r (or None).
    buf: List[List[Optional[int]]] = [[None] * n for _ in range(p)]
    for j in range(n):
        buf[root][j] = pay[j]

    res = SimResult(rounds=0, optimal_rounds=num_rounds(p, n), backend=backend)
    if p == 1:
        res.buffers = buf if keep_buffers else None
        return res

    bundle = get_bundle(p, root)
    q, skip = bundle.q, bundle.skips
    x = bundle.virtual_rounds(n)
    # Working copies of the per-round block indices (x virtual rounds
    # folded in); incremented by q after each use exactly as in
    # Algorithm 1.  Rows are indexed by REAL rank.
    recv_adj, send_adj = bundle.adjusted_tables(n)
    rb = recv_adj.tolist()
    sb = send_adj.tolist()

    for i in range(x, n + q - 1 + x):
        k = i % q
        # Gather the messages of this round first (synchronous round model):
        # rank r sends buf[r][sb[r][k]] to (r + skip[k]) % p.
        msgs: List[Tuple[int, int, Optional[int]]] = []  # (dst, blk, payload)
        for r in range(p):
            blk = sb[r][k]
            t = (r + skip[k]) % p
            if blk < 0 or t == root:
                continue  # nonexistent block / never send to the root
            blk_eff = min(blk, n - 1)
            payload = buf[r][blk_eff]
            assert payload is not None, (
                f"p={p} n={n} round={i} k={k}: rank {r} must send block "
                f"{blk_eff} it does not have"
            )
            msgs.append((t, blk_eff, payload))
        for dst, blk, payload in msgs:
            rblk = rb[dst][k]
            assert rblk >= 0, f"receiver {dst} got unexpected block in round {i}"
            rblk_eff = min(rblk, n - 1)
            assert rblk_eff == blk, (
                f"p={p} n={n} round={i}: rank {dst} expected block {rblk_eff}, "
                f"got {blk}"
            )
            assert np.array_equal(payload, pay[blk]), "payload corrupted"
            buf[dst][blk] = payload
            res.messages += 1
            res.blocks_moved += 1
        for r in range(p):
            sb[r][k] += q
            rb[r][k] += q
        res.rounds += 1

    for r in range(p):
        for j in range(n):
            assert buf[r][j] is not None and np.array_equal(buf[r][j], pay[j]), (
                f"p={p} n={n}: rank {r} missing block {j}"
            )
    assert res.rounds == res.optimal_rounds
    if backend is not None:
        from .comm import host_plan

        vals = np.asarray(pay)
        got = host_plan("broadcast", p, n, root=root, backend=backend,
                        device=device).run(vals)
        expect = got[root]  # reference payloads in data-plane block shape
        assert torch.equal(expect.reshape(vals.shape).cpu(),
                           torch.from_numpy(vals))
        for r in range(p):
            assert torch.equal(got[r], expect), (
                f"p={p} n={n} root={root}: {backend} data plane diverged "
                f"from the reference at rank {r}"
            )
    res.buffers = buf if keep_buffers else None
    return res


def simulate_allgather(
    p: int,
    n: int,
    sizes: Optional[List[int]] = None,
    keep_buffers: bool = False,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> SimResult:
    """Algorithm 2: all-to-all broadcast (irregular allgather).

    Every processor j contributes n blocks (of per-processor size
    sizes[j] if given; sizes only affect the volume counter).  Verifies
    that after n-1+q rounds every processor holds all p*n blocks.
    ``backend`` additionally certifies the round-step data plane
    bit-exactly on ``device``, as in :func:`simulate_broadcast`.
    """
    bundle = get_bundle(p)
    q, skip = bundle.q, bundle.skips
    x = bundle.virtual_rounds(n)
    recv = bundle.adjusted_tables(n)[0].tolist()

    # recvblocks[r][j][k]: schedule of rank r for root j = recv of (r-j) mod p
    # sendblocks[r][j][k] = recvblocks[f^k][j][k] with f^k = (r - skip[k]) % p
    # (both are realized by row rotation of the single recv table).

    buf: List[List[List[Optional[Tuple[int, int]]]]] = [
        [[None] * n for _ in range(p)] for _ in range(p)
    ]
    for j in range(p):
        for blk in range(n):
            buf[j][j][blk] = (j, blk)

    res = SimResult(rounds=0, optimal_rounds=num_rounds(p, n), backend=backend)
    if p == 1:
        res.buffers = buf if keep_buffers else None
        return res
    if sizes is None:
        sizes = [1] * p

    # Working per-(rank, root) block counters.
    rb = [[list(recv[(r - j) % p]) for j in range(p)] for r in range(p)]

    for i in range(x, n + q - 1 + x):
        k = i % q
        # Pack phase: every rank sends, for every root j != t, one block.
        round_msgs = []
        for r in range(p):
            t = (r + skip[k]) % p
            payloads: Dict[int, Tuple[int, Optional[Tuple[int, int]]]] = {}
            for j in range(p):
                if j == t:
                    continue  # t is root for j == t: already has it
                # sendblocks_r[j][k] = recvblocks[(j - skip[k]) mod p][k]
                #                    = recv_schedule((r - j + skip[k]) mod p)[k]
                # i.e. exactly what the to-processor t expects for root j.
                blk = rb[t][j][k]  # == sendblocks[r][j][k] (lockstep counters)
                if blk < 0:
                    continue
                blk_eff = min(blk, n - 1)
                payload = buf[r][j][blk_eff]
                assert payload is not None, (
                    f"p={p} n={n} round={i}: rank {r} missing block "
                    f"({j},{blk_eff}) to send"
                )
                payloads[j] = (blk_eff, payload)
                res.blocks_moved += 1
            round_msgs.append((r, t, payloads))
            res.messages += 1
        # Unpack phase.
        for r, t, payloads in round_msgs:
            for j, (blk, payload) in payloads.items():
                rblk = rb[t][j][k]
                rblk_eff = min(rblk, n - 1)
                assert rblk >= 0 and rblk_eff == blk, (
                    f"p={p} n={n} round={i}: root {j} rank {t} expected "
                    f"{rblk}, got {blk}"
                )
                assert payload == (j, blk)
                buf[t][j][blk] = payload
        for r in range(p):
            for j in range(p):
                rb[r][j][k] += q
        res.rounds += 1

    for r in range(p):
        for j in range(p):
            for blk in range(n):
                assert buf[r][j][blk] == (j, blk), (
                    f"p={p} n={n}: rank {r} missing block ({j},{blk})"
                )
    assert res.rounds == res.optimal_rounds
    if backend is not None:
        from .comm import host_plan

        # Distinct (root, block) payload values, delivered everywhere.
        vals = np.arange(p * n, dtype=np.int64).reshape(p, n) * 7 + 3
        got = host_plan("allgather", p, n, backend=backend,
                        device=device).run(vals).cpu()
        for r in range(p):
            assert np.array_equal(got[r].reshape(p, n).numpy(), vals), (
                f"p={p} n={n}: {backend} data plane diverged from the "
                f"reference at rank {r}"
            )
    res.buffers = buf if keep_buffers else None
    return res


def simulate_allbroadcast(
    p: int,
    n: int,
    sizes: Optional[List[int]] = None,
    keep_buffers: bool = False,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> SimResult:
    """All-broadcast (the paper's name for all-to-all broadcast).

    Every processor broadcasts its n blocks to every other processor in
    the same n-1+q rounds; identical to :func:`simulate_allgather`, kept
    under the collective-family name of arXiv:2407.18004.
    """
    return simulate_allgather(
        p, n, sizes=sizes, keep_buffers=keep_buffers, backend=backend,
        device=device,
    )


# --------------------------------------------------- reversed schedules


def simulate_reduce(
    p: int,
    n: int,
    root: int = 0,
    op: str = "+",
    values: Optional[np.ndarray] = None,
    keep_buffers: bool = True,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> SimResult:
    """Reduction of n blocks to ``root`` by time-reversing Algorithm 1.

    Every processor contributes ``values[r]`` (shape [p, n]; a seeded
    int array when omitted).  Reduction round t replays forward round
    R-1-t with edges flipped: rank r forwards the partial of the block it
    forward-*received* in that round to its forward from-neighbor
    (r - skip[k]) % p, drains it, and accumulates the incoming partial
    into the block it forward-*sent*.  After exactly R = n-1+q rounds the
    root holds the op-reduction of every block and every other rank is
    fully drained -- both asserted, along with exactly-once accumulation
    of every (origin rank, block) contribution.

    ``res.buffers[r][j]`` is rank r's final partial of block j (the
    op-identity is represented as None; ``buffers[root]`` is the result).
    ``backend`` ("torch" / "cuda") additionally executes the reversed
    round-step data plane on ``device`` and asserts that the root's
    result matches this reference bit for bit (for float ``+`` too: both
    accumulate in the same schedule order) and that every other rank's
    data slots hold the op identity.
    """
    opf = _OPS[op]
    if values is None:
        values = np.arange(p * n, dtype=np.int64).reshape(p, n) ** 2 % 1013
    values = np.asarray(values)
    assert values.shape[0] == p and values.shape[1] == n

    # Partial state: vals[r][j] (None == op identity / drained) and the
    # multiset-of-origins certificate contrib[r][j].
    vals: List[List[Optional[np.ndarray]]] = [
        [values[r][j] for j in range(n)] for r in range(p)
    ]
    contrib: List[List[set]] = [[{r} for _ in range(n)] for r in range(p)]

    res = SimResult(rounds=0, optimal_rounds=num_rounds(p, n), backend=backend)
    if p == 1:
        res.buffers = vals if keep_buffers else None
        return res

    bundle = get_bundle(p, root)
    skip = bundle.skips
    fwd_blocks, acc_blocks, ks = bundle.reversed_per_round_tables(n)

    for t in range(fwd_blocks.shape[0]):
        k = int(ks[t])
        # Pack phase: capture every forwarded partial before any drain
        # (synchronous round model; a rank may forward and accumulate the
        # same clamped block in one round -- capture-drain-accumulate).
        msgs: List[Tuple[int, int, int, Optional[np.ndarray], set]] = []
        for r in range(p):
            e = int(fwd_blocks[t, r])
            # Idle entry, or the root: forward rounds never send TO the
            # root (it has everything), so the reversal never sends FROM
            # it (phase offsets can lift its negative entries >= 0 in
            # final-phase capped rounds -- those forward edges were the
            # suppressed redundant re-sends to the root).
            if e < 0 or r == root:
                continue
            blk = min(e, n - 1)
            dst = (r - skip[k]) % p
            msgs.append((r, dst, blk, vals[r][blk], contrib[r][blk]))
            res.messages += 1
            res.blocks_moved += 1
        # Drain phase: a forwarded partial leaves its sender.
        for r, _, blk, _, _ in msgs:
            vals[r][blk] = None
            contrib[r][blk] = set()
        # Accumulate phase.
        for r, dst, blk, v, c in msgs:
            e = int(acc_blocks[t, dst])
            assert e >= 0 and min(e, n - 1) == blk, (
                f"p={p} n={n} round={t}: rank {dst} expected block "
                f"{e}, got {blk} from {r}"
            )
            if not c:
                continue  # an already-drained (identity) partial
            assert contrib[dst][blk].isdisjoint(c), (
                f"p={p} n={n} round={t}: duplicate contribution "
                f"{contrib[dst][blk] & c} for block {blk} at rank {dst}"
            )
            contrib[dst][blk] |= c
            vals[dst][blk] = v if vals[dst][blk] is None else opf(vals[dst][blk], v)
        res.rounds += 1

    everyone = set(range(p))
    for j in range(n):
        assert contrib[root][j] == everyone, (
            f"p={p} n={n}: root {root} missing contributions "
            f"{everyone - contrib[root][j]} for block {j}"
        )
    for r in range(p):
        if r == root:
            continue
        for j in range(n):
            assert not contrib[r][j], (
                f"p={p} n={n}: rank {r} kept a partial of block {j}"
            )
    assert res.rounds == res.optimal_rounds
    if backend is not None:
        from ..kernels.reduce_ops import op_identity
        from .comm import host_plan

        got = host_plan("reduce", p, n, root=root, op=op, backend=backend,
                        device=device).run(values).cpu()
        ref_root = np.stack([np.asarray(vals[root][j]) for j in range(n)])
        assert np.array_equal(got[root].reshape(ref_root.shape).numpy(),
                              ref_root), (
            f"p={p} n={n} root={root} op={op}: {backend} data plane "
            f"diverged from the reference reduction"
        )
        drained = torch.cat([got[:root], got[root + 1:]])
        assert bool((drained == op_identity(op, got.dtype)).all()), (
            f"p={p} n={n} root={root} op={op}: {backend} data plane left "
            f"a partial on a non-root rank"
        )
    res.buffers = vals if keep_buffers else None
    return res


def simulate_allreduce(
    p: int,
    n: int,
    root: int = 0,
    op: str = "+",
    values: Optional[np.ndarray] = None,
    keep_buffers: bool = True,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> SimResult:
    """All-reduction: reduce to ``root`` then broadcast the result back.

    The reversed reduction (n-1+q rounds) composes with the forward
    broadcast (n-1+q rounds) on the same cached bundle, for a total of
    exactly 2(n-1) + 2*ceil(log2 p) rounds.  The return path runs the
    payload-checked Algorithm-1 simulation carrying the reduced blocks,
    so every rank provably ends with the op-reduction of every block.
    ``backend`` certifies the round-step data plane of *both* phases
    bit-exactly against the reference, as in :func:`simulate_reduce` /
    :func:`simulate_broadcast`.
    """
    red = simulate_reduce(
        p, n, root=root, op=op, values=values, keep_buffers=True,
        backend=backend, device=device,
    )
    res = SimResult(
        rounds=red.rounds,
        optimal_rounds=2 * num_rounds(p, n),
        messages=red.messages,
        blocks_moved=red.blocks_moved,
        backend=backend,
    )
    reduced = red.buffers[root]
    bcast = simulate_broadcast(
        p, n, root=root, keep_buffers=keep_buffers, payloads=reduced,
        backend=backend, device=device,
    )
    res.rounds += bcast.rounds
    res.messages += bcast.messages
    res.blocks_moved += bcast.blocks_moved
    assert res.rounds == res.optimal_rounds
    res.buffers = bcast.buffers
    return res
