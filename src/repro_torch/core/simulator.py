"""Round-based message-passing simulator of the collective family.

Port of ``repro.core.simulator`` (``SimResult``, ``simulate_broadcast``,
``simulate_allgather``, ``simulate_allbroadcast``, ``simulate_reduce``,
``simulate_allreduce``, and the two-level ``HierSimResult``,
``simulate_hier_broadcast``, ``simulate_hier_reduce`` and
``simulate_hier_allreduce``).  Executes the paper's broadcast and all-to-all
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
    "simulate_hier_broadcast",
    "simulate_hier_reduce",
    "simulate_hier_allreduce",
    "SimResult",
    "HierSimResult",
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


# ---------------------------------------------- hierarchical composition
#
# Two-level (nodes x cores) collectives: one flat circulant phase per
# level (repro_torch.core.hier).  The inter phase runs among the node
# leaders and the intra phases run inside every node *in parallel*, so
# the composed round count is the SUM of the per-level optima while the
# per-node simulations each re-certify their own level (payload
# delivery / exactly-once contribution certificates come from the flat
# simulators, which raise on any violation).  ``backend`` additionally
# executes the composed hierarchical data plane
# (:func:`repro_torch.core.hier.hier_host_plan`) on ``device`` and
# asserts it bit-exact against the NumPy reference -- the certification
# of the 36x32 evaluation topology.


@dataclass
class HierSimResult:
    rounds: int                      # composed communication rounds
    optimal_rounds: int              # the closed-form two-level optimum
    rounds_inter: int                # inter-node (leader) rounds
    rounds_intra: int                # intra-node rounds
    messages: int = 0                # point-to-point messages, all nodes
    blocks_moved: int = 0
    buffers: Optional[list] = None
    backend: Optional[str] = None


def _hier_atoms(nodes: int, cores: int, n_inter: int, n_intra: int,
                payloads: Optional[List]) -> List:
    """The message as a flat list of atoms divisible into both block
    counts (default m = n_inter * n_intra distinct ints)."""
    if payloads is None:
        return list(range(n_inter * n_intra))
    m = len(payloads)
    assert m % n_inter == 0 and m % n_intra == 0, (
        f"hier payload length {m} must divide into both n_inter={n_inter} "
        f"and n_intra={n_intra} blocks"
    )
    return list(payloads)


def _chunk(atoms: List, n: int) -> List[Tuple]:
    """Group atoms into n equal tuple-blocks (tuples compare by value in
    the flat simulators' payload checks)."""
    sz = len(atoms) // n
    return [tuple(atoms[i * sz: (i + 1) * sz]) for i in range(n)]


def _hier_default_values(nodes: int, cores: int, m: int) -> np.ndarray:
    """Seeded default contributions for the hier reductions: distinct
    int64 values, so '+' is bit-exact and duplicate/missing
    contributions shift the result.  One definition shared by
    simulate_hier_reduce and simulate_hier_allreduce (the latter's
    backend certification must regenerate the identical array)."""
    return (np.arange(nodes * cores * m, dtype=np.int64)
            .reshape(nodes, cores, m) ** 2 + 7) % 2027


def _first_rank_off(got: torch.Tensor, want: np.ndarray):
    """The first (node, core) of ``got`` [nodes, cores, m] whose row is
    not ``want`` [m] (compared as ``np.array_equal`` does), or None; one
    comparison for all ranks."""
    expect = torch.from_numpy(np.ascontiguousarray(want)).to(got.device)
    off = (got != expect).flatten(2).any(2)
    if not bool(off.any()):
        return None
    return tuple(int(i) for i in off.nonzero()[0])


def simulate_hier_broadcast(
    nodes: int,
    cores: int,
    n_inter: int,
    n_intra: int,
    root: int = 0,
    keep_buffers: bool = False,
    payloads: Optional[List] = None,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> HierSimResult:
    """Two-level broadcast: inter-node among leaders, then intra-node.

    The root's flat node-major rank is ``root = node * cores + core``.
    The message is a list of atoms (default ``n_inter * n_intra``
    distinct values) re-blocked between the levels exactly as the data
    plane re-blocks its buffers; each flat phase re-certifies its own
    delivery, and the composed round count must equal the closed form
    :func:`repro_torch.core.hier.hier_rounds`.  ``backend`` ("torch" /
    "cuda") additionally runs the composed host data plane on
    ``device`` (``None`` means ``"cuda"``) and asserts every rank's
    final state bit-exact against the atoms.
    """
    from .hier import hier_host_plan, hier_rounds

    rootN, rootC = divmod(root, cores)
    atoms = _hier_atoms(nodes, cores, n_inter, n_intra, payloads)
    res = HierSimResult(
        rounds=0,
        optimal_rounds=hier_rounds("broadcast", nodes, cores, n_inter,
                                   n_intra),
        rounds_inter=0, rounds_intra=0, backend=backend,
    )
    # Phase A: the leaders (core rootC of every node) run the flat
    # inter-node broadcast of the n_inter-blocked message.
    if nodes > 1:
        a = simulate_broadcast(nodes, n_inter, root=rootN,
                               payloads=_chunk(atoms, n_inter))
        res.rounds_inter = a.rounds
        res.messages += a.messages
        res.blocks_moved += a.blocks_moved
    # Phase B: every node runs the same intra-node broadcast in
    # parallel (identical payloads after phase A -> simulate once,
    # count messages nodes times, rounds once).
    if cores > 1:
        b = simulate_broadcast(cores, n_intra, root=rootC,
                               payloads=_chunk(atoms, n_intra))
        res.rounds_intra = b.rounds
        res.messages += nodes * b.messages
        res.blocks_moved += nodes * b.blocks_moved
    res.rounds = res.rounds_inter + res.rounds_intra
    assert res.rounds == res.optimal_rounds
    assert res.rounds_inter == num_rounds(nodes, n_inter)
    assert res.rounds_intra == num_rounds(cores, n_intra)
    if backend is not None:
        vals = np.asarray(atoms)
        got = hier_host_plan("broadcast", nodes, cores, n_inter, n_intra,
                             root=root, backend=backend,
                             device=device).run(vals)
        off = _first_rank_off(got, vals)
        assert off is None, (
            f"{nodes}x{cores} n=({n_inter},{n_intra}) root={root}: "
            f"{backend} hier data plane diverged at rank {off}"
        )
    if keep_buffers:
        res.buffers = [[list(atoms) for _ in range(cores)]
                       for _ in range(nodes)]
    return res


def simulate_hier_reduce(
    nodes: int,
    cores: int,
    n_inter: int,
    n_intra: int,
    root: int = 0,
    op: str = "+",
    values: Optional[np.ndarray] = None,
    keep_buffers: bool = True,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> HierSimResult:
    """Two-level reduction: intra-reduce to each leader, inter-reduce to
    the root.

    ``values`` has shape ``[nodes, cores, m]`` with ``m`` divisible by
    both block counts (a seeded int array when omitted, so '+' is
    bit-exact).  Every per-node intra simulation and the inter
    simulation carry the flat simulators' exactly-once contribution
    certificates, composing to exactly-once over all nodes*cores
    origins; the final value at the root is asserted bit-exact against
    the NumPy op-reduction over the flat rank axis.  ``backend``
    additionally certifies the composed host data plane on ``device``
    against the same reference.
    """
    from .hier import hier_host_plan, hier_rounds

    _OPS[op]  # validate the op name before any sub-simulation runs
    if values is None:
        values = _hier_default_values(nodes, cores, n_inter * n_intra)
    values = np.asarray(values)
    assert values.shape[:2] == (nodes, cores)
    m = values.shape[-1] if values.ndim > 2 else 1
    values = values.reshape(nodes, cores, m)
    assert m % n_inter == 0 and m % n_intra == 0, (
        f"hier values length {m} must divide into both n_inter={n_inter} "
        f"and n_intra={n_intra} blocks"
    )
    rootN, rootC = divmod(root, cores)
    res = HierSimResult(
        rounds=0,
        optimal_rounds=hier_rounds("reduce", nodes, cores, n_inter, n_intra),
        rounds_inter=0, rounds_intra=0, backend=backend,
    )
    # Phase A: every node reduces its cores' contributions to the
    # leader (parallel across nodes: rounds counted once).
    partials = np.empty((nodes, m), values.dtype)
    if cores > 1:
        for j in range(nodes):
            a = simulate_reduce(
                cores, n_intra, root=rootC, op=op,
                values=values[j].reshape(cores, n_intra, m // n_intra),
            )
            res.rounds_intra = a.rounds
            res.messages += a.messages
            res.blocks_moved += a.blocks_moved
            partials[j] = np.stack(a.buffers[rootC]).reshape(-1)
    else:
        partials[:] = values[:, 0]
    # Phase B: the leaders reduce the node partials to the root.
    if nodes > 1:
        b = simulate_reduce(
            nodes, n_inter, root=rootN, op=op,
            values=partials.reshape(nodes, n_inter, m // n_inter),
        )
        res.rounds_inter = b.rounds
        res.messages += b.messages
        res.blocks_moved += b.blocks_moved
        final = np.stack(b.buffers[rootN]).reshape(-1)
    else:
        final = partials[0]
    res.rounds = res.rounds_inter + res.rounds_intra
    assert res.rounds == res.optimal_rounds
    # The flat certificates compose: each intra run delivered every core
    # of its node exactly once into the leader partial, the inter run
    # delivered every node partial exactly once into the root.  For the
    # order-free ops (any int '+', any 'max') the end-to-end reference
    # is exact.
    flat = values.reshape(nodes * cores, m)
    expect = np.maximum.reduce(flat) if op == "max" else np.add.reduce(flat)
    if op == "max" or np.issubdtype(values.dtype, np.integer):
        assert np.array_equal(final, expect), (
            f"{nodes}x{cores}: hier reduction diverged from the NumPy "
            f"reference"
        )
    else:
        np.testing.assert_allclose(final, expect, rtol=1e-6)
    if backend is not None:
        got = hier_host_plan("reduce", nodes, cores, n_inter, n_intra,
                             root=root, op=op, backend=backend,
                             device=device).run(values)
        assert np.array_equal(got.cpu().numpy(), final), (
            f"{nodes}x{cores} n=({n_inter},{n_intra}) root={root} op={op}: "
            f"{backend} hier data plane diverged from the reference"
        )
    res.buffers = [final] if keep_buffers else None
    return res


def simulate_hier_allreduce(
    nodes: int,
    cores: int,
    n_inter: int,
    n_intra: int,
    root: int = 0,
    op: str = "+",
    values: Optional[np.ndarray] = None,
    keep_buffers: bool = True,
    backend: Optional[str] = None,
    device: Union[str, torch.device, None] = None,
) -> HierSimResult:
    """Two-level all-reduction: intra-reduce -> inter-allreduce among
    the leaders -> intra-broadcast fan-out, ``2(n_C-1+q_C) +
    2(n_N-1+q_N)`` composed rounds.  The return path re-runs the
    payload-checked broadcast simulations carrying the reduced blocks,
    so every rank provably ends with the composed op-reduction;
    ``backend`` certifies the composed data plane of all four sweeps on
    ``device``.
    """
    from .hier import hier_host_plan, hier_rounds

    red = simulate_hier_reduce(
        nodes, cores, n_inter, n_intra, root=root, op=op, values=values,
        keep_buffers=True, backend=None,
    )
    res = HierSimResult(
        rounds=red.rounds,
        optimal_rounds=hier_rounds("allreduce", nodes, cores, n_inter,
                                   n_intra),
        rounds_inter=red.rounds_inter,
        rounds_intra=red.rounds_intra,
        messages=red.messages,
        blocks_moved=red.blocks_moved,
        backend=backend,
    )
    reduced = list(red.buffers[0])
    rootN, rootC = divmod(root, cores)
    # Return path: inter broadcast among leaders, intra fan-out -- both
    # carry the reduced payload through the content-checked simulator.
    if nodes > 1:
        b1 = simulate_broadcast(nodes, n_inter, root=rootN,
                                payloads=_chunk(reduced, n_inter))
        res.rounds_inter += b1.rounds
        res.messages += b1.messages
        res.blocks_moved += b1.blocks_moved
    if cores > 1:
        b2 = simulate_broadcast(cores, n_intra, root=rootC,
                                payloads=_chunk(reduced, n_intra))
        res.rounds_intra += b2.rounds
        res.messages += nodes * b2.messages
        res.blocks_moved += nodes * b2.blocks_moved
    res.rounds = res.rounds_inter + res.rounds_intra
    assert res.rounds == res.optimal_rounds
    if backend is not None:
        vals = values
        if vals is None:
            vals = _hier_default_values(nodes, cores, n_inter * n_intra)
        vals = np.asarray(vals).reshape(nodes, cores, -1)
        got = hier_host_plan("allreduce", nodes, cores, n_inter, n_intra,
                             root=root, op=op, backend=backend,
                             device=device).run(vals)
        off = _first_rank_off(got, np.asarray(reduced).reshape(-1))
        assert off is None, (
            f"{nodes}x{cores} n=({n_inter},{n_intra}) op={op}: "
            f"{backend} hier data plane diverged at rank {off}"
        )
    res.buffers = [reduced] if keep_buffers else None
    return res
