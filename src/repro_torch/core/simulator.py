"""Round-based message-passing simulator of the n-block broadcast.

Port of ``repro.core.simulator`` (``SimResult``, ``simulate_broadcast``).
Executes the paper's broadcast (Algorithm 1) over a simulated
fully-connected, one-ported, bidirectional network in plain Python and
checks that it completes in exactly n-1+q rounds with every block at
every rank.  It is the end-to-end functional oracle for the schedules.

Backend certification: ``backend="torch"`` or ``backend="cuda"``
additionally executes the broadcast's *data plane* -- the round steps of
:mod:`repro_torch.core.roundstep` on a device, through the cached host
plan of :func:`repro_torch.core.comm.host_plan` -- and asserts that its
final buffers match the message-passing reference bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .engine import get_bundle
from .schedule import num_rounds

__all__ = ["simulate_broadcast", "SimResult"]


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
