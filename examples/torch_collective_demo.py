"""Circulant collectives through the PyTorch port's communicator API.

    PYTHONPATH=src python examples/torch_collective_demo.py [--device cpu]

Runs the paper's n-block broadcast, an all-reduction, and the irregular
allgather through the plan/execute front-end (:mod:`repro_torch.core.comm`)
over ``StackedGroup(8)``: 8 ranks as the rows of one buffer on the CUDA
card (the round-step kernels), or with ``--device cpu`` on the CPU (their
plain versions).  One ``CirculantComm`` a group, one ``CollectivePlan``
per (kind, payload spec) precomputing the O(log p) schedule work on the
host, and plan calls that run only the rounds.  Also broadcasts a
mixed-dtype pytree in one shared schedule and prints the per-round
communication plan for one rank.
"""

import argparse
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core.comm import StackedGroup, get_comm
from repro_torch.kernels import launches
from repro_torch.core.engine import get_bundle


P = 8


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    p = P
    group = StackedGroup(p, device=args.device)
    dev = group.device
    comm = get_comm(group)
    print(f"ranks: {p} on {dev}")

    # ---- the communication plan of rank 1 for a 5-block broadcast
    n = 5
    bundle = get_bundle(p)
    print(f"\nbroadcast plan p={p}, n={n}: rounds = n-1+q = {bundle.rounds(n)}, "
          f"virtual rounds x={bundle.virtual_rounds(n)}")
    r = 1
    print(f"rank {r}: recv sched {bundle.recv_row(r)}, send sched {bundle.send_row(r)}")
    for rnd, (k, off) in enumerate(bundle.round_plan(n)):
        rb = int(bundle.recv[r][k]) + off
        sb = int(bundle.send[r][k]) + off
        frm = int(bundle.neighbors_in[r][k])
        to = int(bundle.neighbors_out[r][k])
        print(f"  round {rnd}: recv block {rb if rb>=0 else '--'} from {frm}, "
              f"send block {sb if sb>=0 else '--'} to {to}")

    # ---- plan once, execute many
    rng = np.random.default_rng(0)
    data = rng.normal(size=(p, 1000)).astype(np.float32)
    xs = torch.from_numpy(data).to(dev)
    plan = comm.plan("broadcast", xs, n_blocks=n)
    print(f"\nplan: {plan.describe()}")
    out = plan(xs)
    out = plan(xs)
    assert np.array_equal(out.cpu().numpy(), np.broadcast_to(data[0], data.shape)), \
        "broadcast mismatch"
    assert plan is comm.plan("broadcast", xs, n_blocks=n), "plan cache miss"
    print("CollectivePlan broadcast: every rank holds root's data  OK")

    # ---- pytree payload: mixed dtypes, ragged leaves, ONE shared schedule
    state = {
        "w": torch.from_numpy(rng.normal(size=(p, 37, 3)).astype(np.float32)).to(dev),
        "step": torch.from_numpy(rng.integers(0, 100, size=(p, 11)).astype(np.int32)).to(dev),
    }
    tree_out = comm.broadcast(state, n_blocks=4, root=p - 1)
    for key, leaf in tree_out.items():
        want = state[key][p - 1].expand_as(leaf)
        assert torch.equal(leaf, want), key
    print("pytree broadcast (float32 + int32 leaves, one schedule)  OK")

    # ---- all-reduction on the same communicator
    vals = rng.integers(-100, 100, size=(p, 257)).astype(np.int32)
    red = comm.allreduce(torch.from_numpy(vals).to(dev), n_blocks=3)
    assert np.array_equal(red.cpu().numpy(), np.broadcast_to(vals.sum(0), vals.shape))
    print("circulant allreduce: every rank holds the sum  OK")

    # ---- irregular allgather, degenerate sizes (paper Figure 2's hard case)
    sizes = [900] + [20] * (p - 1)
    rows = np.zeros((p, max(sizes)), np.float32)
    for j in range(p):
        rows[j, : sizes[j]] = rng.normal(size=sizes[j])
    out = comm.allgatherv(torch.from_numpy(rows).to(dev), sizes, n_blocks=3).cpu().numpy()
    for j in range(p):
        assert np.array_equal(out[j, : sizes[j]], rows[j, : sizes[j]])
    print("circulant allgatherv (degenerate sizes): all rows delivered  OK")
    print(f"kernel launches: {launches()}")
    print("OK")


if __name__ == "__main__":
    main()
