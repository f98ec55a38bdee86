"""The work files against hand figures: the bytes each collective's
semantics need at p = 1152, and the round-step kernels' launches and
bytes on a plan whose tables are known."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchcells import small_cell
from bench.harness import cell as cellrun
from bench.harness import files, traffic

P, M, m = 1152, 16 * 2 ** 20, 8 * 2 ** 10
HBM = files.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"]


def _traffic(p, nbytes, dtype=torch.float32, leaves=1):
    one = traffic.Leaf(name=None, dtype=dtype, elements=0, values="normal")
    one.elements = nbytes // one.itemsize
    return SimpleNamespace(p=p, leaves=[one] * leaves, sizes=None)


@pytest.mark.parametrize("kind,args,nbytes,ms", [
    ("broadcast", (P, M), 19_344_130_048, 5.774),
    ("allreduce", (P, M), 38_654_705_664, 11.539),
    ("allgather", (P, m), 10_881_073_152, 3.248),
])
def test_collective_bytes(kind, args, nbytes, ms):
    work = files.module("work", kind).work
    w = work(_traffic(*args))
    assert w["bytes"] == nbytes
    assert w["bytes"] / HBM * 1e3 == pytest.approx(ms, abs=5e-4)
    assert w["flops"] / 67e12 * 1e3 < 0.1
    # two leaves of half the bytes each: the same work
    assert work(_traffic(args[0], args[1] // 2, leaves=2)) == w


def test_step_mfu_reads_the_least_time_over_the_step():
    read = files.module("metrics", "step_mfu").read
    peaks = files.peaks("NVIDIA H100 80GB HBM3")
    win = SimpleNamespace(calls=10, wall=10 * 5.774e-3 * 4)
    rec = {"peaks": peaks, "window": win, "traffic": SimpleNamespace(
        collective="broadcast", **vars(_traffic(P, M)))}
    assert read(rec) == pytest.approx(25.0, abs=0.01)
    rec["peaks"] = None
    assert read(rec) is None


def _forward(recv, send, bs=10, rows=None):
    recv, send = np.asarray(recv), np.asarray(send)
    return {"loop": "forward", "rows": recv.shape[1], "bs": bs, "itemsize": 4,
            "recv": recv, "send": send}


def test_forward_kernels_on_hand_tables():
    # 3 rounds over 2 rows: shuffles at t = 0, 1; rows differ 1 and 2 times
    ph = _forward([[0, 1], [2, 1], [3, 3]], [[5, 5], [0, 0], [3, 0]])
    row = 10 * 4
    assert files.module("work", "pack_kernel").launches([ph]) == (1, 2 * (2 * row + 4))
    assert files.module("work", "unpack_kernel").launches([ph]) == (1, 2 * (2 * row + 4))
    count, nbytes = files.module("work", "shuffle_kernel").launches([ph])
    assert count == 2
    assert nbytes == 2 * 2 * (3 * row + 8) + (1 + 2) * row
    assert files.module("work", "shuffle_short_kernel").launches([ph]) == (count, nbytes)
    assert files.module("work", "acc_shuffle_kernel").launches([ph]) == (0, 0)


def test_reduce_kernel_on_hand_tables():
    fwd = np.array([[1, 2], [0, 2], [3, 3]])    # the garbage round last
    acc = np.array([[0, 0], [0, 1]])
    ph = {"loop": "reduce", "rows": 2, "bs": 5, "itemsize": 8, "fwd": fwd, "acc": acc}
    row = 5 * 8
    count, nbytes = files.module("work", "acc_shuffle_kernel").launches([ph])
    # steps: (fwd[2], fwd[0]) differ 2, (acc[0], fwd[1]) differ 1, (acc[1], fwd[2]) differ 2
    assert count == 3
    assert nbytes == 3 * 2 * (4 * row + 8) + (2 + 1 + 2) * 2 * row


@pytest.mark.parametrize("name,kernel,launches", [
    ("circulant-p1152.bcast-16MiB", "shuffle_kernel", lambda pl: pl.rounds - 1),
    ("circulant-p1152.allreduce-16MiB", "acc_shuffle_kernel", lambda pl: pl.rounds // 2 + 1),
    ("circulant-p1152.allgather-8KiB", "shuffle_short_kernel", lambda pl: pl.rounds - 1),
    ("hier-36x32.bcast-16MiB", "shuffle_kernel", lambda pl: pl.rounds - 2),
])
def test_plan_phases_count_the_loops_launches(name, kernel, launches):
    cell = small_cell(name)
    t, sut = cellrun.setup(cell, 7, torch.device("cpu"))
    phases = sut.phases()
    count, nbytes = files.module("work", kernel).launches(phases)
    assert count == launches(sut.plan) and nbytes > 0


def test_reduce_scatter_rows_hold_one_roots_part():
    """A reduce_scatter's rows are (rank, root) pairs, each a p-th of a
    rank's elements: a launch moves what the allreduce's does over p rows."""
    cell = small_cell("circulant-p1152.allreduce-16MiB")
    cell.mix = {"collective": "reduce_scatter", "entry": "call",
                "leaves": [{"bytes_per_rank": 8 * 4 * 960, "values": "integer",
                            "value_bound": 9}], "checks": {"max_abs_diff": 0.0}}
    t, sut = cellrun.setup(cell, 7, torch.device("cpu"))
    (ph,) = sut.phases()
    n = sut.plan.n_blocks
    assert ph["loop"] == "reduce" and ph["rows"] == 64 and ph["bs"] == -(-960 // n)
    count, _ = files.module("work", "acc_shuffle_kernel").launches([ph])
    assert count == sut.plan.rounds + 1
