"""Quickstart on the PyTorch port: the paper's algorithms end to end.

    PYTHONPATH=src python examples/torch_quickstart.py [p] [n] [--device cpu]

1. computes the circulant-graph skips for p processors (Algorithm 3),
2. computes every rank's receive + send schedule in O(log p) each
   (Algorithms 5-9),
3. verifies the four correctness conditions of paper §2.1,
4. simulates the n-block broadcast (Algorithm 1): n-1+ceil(log2 p)
   rounds, payload-checked,
5. simulates the all-to-all broadcast (Algorithm 2),
6. prints the Table-2-style schedule for small p,
7. plans and executes a broadcast through the communicator API
   (:mod:`repro_torch.core.comm`) over ``StackedGroup(p)``: p ranks as
   the rows of one buffer, on the CUDA card (the round-step kernels) or,
   with ``--device cpu``, on the CPU (their plain versions).
"""

import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.core import (
    StackedGroup,
    get_bundle,
    get_comm,
    num_rounds,
    simulate_allgather,
    simulate_broadcast,
    verify_bundle,
)
from repro_torch.kernels import launches


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("p", type=int, nargs="?", default=17)
    ap.add_argument("n", type=int, nargs="?", default=7)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    p, n = args.p, args.n
    bundle = get_bundle(p)
    print(f"p={p}  q=ceil(log2 p)={bundle.q}  skips={list(bundle.skips)}")

    verify_bundle(bundle)
    print(f"schedules for all {p} ranks verified against the four "
          "correctness conditions (paper 2.1)")

    if p <= 40:
        print("\nrank : recvblock[0..q-1]        sendblock[0..q-1]")
        for r in range(p):
            print(f"{r:4d} : {str(bundle.recv_row(r)):24s} {bundle.send_row(r)}")

    res = simulate_broadcast(p, n)
    print(f"\nbroadcast  p={p} n={n}: delivered in {res.rounds} rounds "
          f"(optimal = n-1+q = {num_rounds(p, n)}), "
          f"{res.blocks_moved} block transfers (optimal = (p-1)*n = {(p-1)*n})")

    res = simulate_allgather(p, max(1, n // 2))
    print(f"allgather  p={p} n={max(1, n//2)}: delivered in {res.rounds} rounds "
          f"(optimal), {res.blocks_moved} block transfers")

    # ---- the communicator API: p ranks as the rows of one buffer on the
    # device; plan once (bundle + slot tables), execute many.
    group = StackedGroup(p, device=args.device)
    comm = get_comm(group)
    state = {"w": torch.ones((p, 8), device=group.device),
             "step": torch.zeros((p, 3), dtype=torch.int32, device=group.device)}
    state["w"][0] = torch.arange(8, dtype=torch.float32, device=group.device)
    plan = comm.plan("broadcast", state, n_blocks=2)
    out = plan(state)
    assert plan is comm.plan("broadcast", state, n_blocks=2)
    assert torch.equal(out["w"], state["w"][:1].expand(p, 8))
    assert torch.equal(out["step"], state["step"])
    print(f"\ncomm plan/execute on {p} ranks of {group.device}: {plan.describe()}")
    print(f"kernel launches: {launches()}")
    print("\nOK")


if __name__ == "__main__":
    main()
