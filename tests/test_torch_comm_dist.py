"""The communicator over ``torch.distributed``: ``DistGroup`` on gloo.

At p in {2, 5, 8}, p fresh interpreters (``subprocess``, never a fork of
this process) join one gloo group through a ``file://`` rendezvous in
``tmp_path`` and run, as ranks, the modes of ``tests/mp_worker.py``:
broadcast, allgather, allgatherv, overlap, reduce_scatter,
restore_broadcast (``broadcast_state``), reduce, allreduce,
allbroadcast, comm (pytree payloads) and ring.  Each rank passes its
own shard of the seeded global payload and writes what it got back.
Every rank's result must equal, bit for bit, the same call's result on a
``StackedGroup`` in this process (its shard of it, or all of it for the
allgathers, whose result every rank holds; a worker also checks that
``plan.per_rank`` gives its one copy of it).

The workers import ``repro_torch`` only; this process never initializes
a process group or touches the environment of its own.  All three
groups run together, 15 processes, each with one thread.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import collectives as tcoll
from repro_torch.core.comm import StackedGroup, get_comm
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.train.restore_broadcast import broadcast_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PS = (2, 5, 8)
TIMEOUT_S = 100

WORKER = r'''
import pickle, sys
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.core import collectives
from repro_torch.core.comm import DistGroup, get_comm
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.train.restore_broadcast import broadcast_state

rank, p, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                        world_size=p, timeout=timedelta(seconds=60))
try:
    with open(f"{work}/cases.pkl", "rb") as f:
        cases = pickle.load(f)
    group = DistGroup()
    assert (group.p, group.rank) == (p, rank)
    outs = {}
    for name, case in cases.items():
        leaves, treedef = tree_flatten(case["payload"])
        mine = tree_unflatten(treedef, [
            x.view(p, -1, *x.shape[1:])[rank].clone() for x in leaves])
        call, kw = case["call"], case["kw"]
        if call == "plan":
            plan = get_comm(group, backend="torch").plan(case["kind"], mine, **kw)
            out = plan(mine)
            if plan.kind in ("allgather", "allgatherv"):
                # the process's one copy of the replicated result
                for c, o in zip(tree_flatten(plan.per_rank(mine))[0],
                                tree_flatten(out)[0]):
                    assert c.shape == (1,) + o.shape and torch.equal(c[0], o), name
        elif call == "broadcast_state":
            out = broadcast_state(group, mine, backend="torch", **kw)
        elif call == "ring_allgather":
            out = collectives.ring_allgather(group, mine)
        else:
            out = getattr(collectives, call)(group, mine, *case["args"],
                                             backend="torch", **kw)
        outs[name] = tree_flatten(out)[0]
    with open(f"{work}/out{rank}.pkl", "wb") as f:
        pickle.dump(outs, f)
finally:
    dist.destroy_process_group()
'''

MODES = ("broadcast", "allgather", "allgatherv", "overlap", "reduce_scatter",
         "restore_broadcast", "reduce", "allreduce", "allbroadcast", "comm",
         "ring")
#: The calls whose result is the whole gathered array on every rank.
GATHERED = ("allgather", "allbroadcast", "allgatherv", "circulant_allgather",
            "circulant_allbroadcast", "circulant_allgatherv", "ring_allgather")


def _cases(p):
    """mode -> {name: case}, mirroring tests/mp_worker.py's check_* at p.
    ``payload`` is a tree of global tensors with one slice a rank along
    the leading axis."""
    rng = np.random.default_rng(2000 + p)
    modes = {m: {} for m in MODES}

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def i32(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.int32))

    def add(mode, name, payload, kind=None, call="plan", args=(), **kw):
        modes[mode][f"{mode}/{name}"] = dict(kind=kind, payload=payload,
                                             call=call, args=list(args), kw=kw)

    # check_broadcast
    for n in (1, 2, 3, 5, 8):
        add("broadcast", f"n{n}", f32(p, 97), "broadcast", n_blocks=n)
    add("broadcast", "root_mid", f32(p, 97), "broadcast", n_blocks=4, root=p // 2)
    add("broadcast", "root_last", f32(p, 97), "broadcast", n_blocks=4, root=p - 1)
    add("broadcast", "bf16", f32(p, 97).to(torch.bfloat16), "broadcast", n_blocks=3)
    add("broadcast", "int32", i32(-99, 99, p, 97), "broadcast", n_blocks=3)
    # check_allgather
    for n in (1, 2, 5, 8):
        add("allgather", f"n{n}", f32(p * 64), "allgather", n_blocks=n)
    add("allgather", "bf16", f32(p * 64).to(torch.bfloat16), "allgather", n_blocks=3)
    # check_allgatherv
    for name, n, sizes in (
            ("mod3", 2, [10 * (j % 3) + 1 for j in range(p)]),
            ("degenerate", 3, [600] + [1] * (p - 1)),
            ("random", 2, [int(s) for s in rng.integers(1, 50, size=p)])):
        rows = torch.zeros((p, max(sizes)), dtype=torch.int32)
        for j, s in enumerate(sizes):
            rows[j, :s] = torch.from_numpy(rng.integers(0, 1000, size=s))
        add("allgatherv", name, rows, call="circulant_allgatherv", args=[sizes],
            n_blocks=n)
    # check_overlap
    xs = {"w": f32(p, 37), "b": i32(-9, 9, p, 11)}
    for kind in ("broadcast", "allgather", "reduce", "allreduce"):
        root = p - 1 if kind in ("broadcast", "reduce") else 0
        for ov in (False, True):
            add("overlap", f"{kind}_{ov}", xs, kind, n_blocks=3, root=root,
                overlap=ov)
    for ov in (False, True):
        add("overlap", f"reduce_max_{ov}", {"a": xs["w"]}, "reduce", n_blocks=2,
            op="max", overlap=ov)
        add("overlap", f"reduce_scatter_{ov}", {"m": f32(p, p * 8)},
            "reduce_scatter", n_blocks=2, overlap=ov)
    # check_reduce_scatter
    for n in (1, 2, 3, 6):
        add("reduce_scatter", f"n{n}", f32(p, p * 24), call="circulant_reduce_scatter",
            n_blocks=n)
    add("reduce_scatter", "bf16", {"m": f32(p, p * 24).to(torch.bfloat16)},
        "reduce_scatter", n_blocks=3)
    # check_restore_broadcast
    add("restore_broadcast", "n3", {"w": f32(p, 33, 7), "b": f32(p, 13)},
        call="broadcast_state", n_blocks=3)
    add("restore_broadcast", "mixed", {"w": f32(p, 33, 7), "step": i32(0, 9, p),
                                       "h": f32(p, 9).to(torch.bfloat16)},
        call="broadcast_state", root=p - 1)
    # check_reduce
    for n in (1, 2, 3, 5):
        for root in sorted({0, p - 1}):
            add("reduce", f"int32_n{n}_root{root}", i32(-1000, 1000, p, 41),
                call="circulant_reduce", n_blocks=n, root=root)
            add("reduce", f"max_n{n}_root{root}", f32(p, 41),
                call="circulant_reduce", n_blocks=n, root=root, op="max")
    # check_allreduce
    for n in (1, 2, 4):
        add("allreduce", f"int32_n{n}", i32(-1000, 1000, p, 53),
            call="circulant_allreduce", n_blocks=n)
        add("allreduce", f"max_n{n}", f32(p, 53), call="circulant_allreduce",
            n_blocks=n, op="max")
    # check_allbroadcast
    for n in (1, 3):
        add("allbroadcast", f"n{n}", f32(p * 48), call="circulant_allbroadcast",
            n_blocks=n)
    # check_comm: pytrees, mixed dtypes, ragged leaves
    tree = {"w": f32(p, 37, 3), "b": i32(0, 100, p, 11),
            "t": (f32(p, 5).to(torch.bfloat16),)}
    add("comm", "broadcast", tree, "broadcast", n_blocks=4, root=p - 1)
    data = {"a": i32(-50, 50, p, 13), "b": i32(-50, 50, p, 7, 2)}
    add("comm", "reduce", data, "reduce", n_blocks=3, root=1)
    add("comm", "reduce_max", {"a": f32(p, 13), "b": f32(p, 7, 2)}, "reduce",
        n_blocks=3, op="max")
    add("comm", "allreduce", data, "allreduce", n_blocks=2)
    add("comm", "allgather", {"x": f32(p * 6), "y": i32(0, 9, p, 4)}, "allgather",
        n_blocks=3)
    add("comm", "reduce_scatter_int32",
        {"m": torch.from_numpy((rng.integers(-1000, 1000, size=(p, p * 8))
                                * 100003).astype(np.int32))},
        "reduce_scatter", n_blocks=3)
    sizes = {"u": [3 * j + 1 for j in range(p)], "v": [7] * p}
    vin = {"u": torch.zeros((p, 3 * p), dtype=torch.int32), "v": torch.zeros((p, 9))}
    for j in range(p):
        vin["u"][j, :sizes["u"][j]] = torch.from_numpy(
            rng.integers(1, 99, size=sizes["u"][j]).astype(np.int32))
        vin["v"][j, :7] = f32(7)
    add("comm", "allgatherv", vin, "allgatherv", n_blocks=2, sizes=sizes)
    add("comm", "shim_broadcast", tree["w"], call="circulant_broadcast",
        n_blocks=4, root=p - 1)
    # check_ring
    add("ring", "arange", torch.arange(p * 16, dtype=torch.float32),
        call="ring_allgather")
    return modes


def _stacked(case, p):
    group = StackedGroup(p, device="cpu")
    xs, call, kw = case["payload"], case["call"], case["kw"]
    if call == "plan":
        return get_comm(group, backend="torch").plan(case["kind"], xs, **kw)(xs)
    if call == "broadcast_state":
        return broadcast_state(group, xs, backend="torch", **kw)
    if call == "ring_allgather":
        return tcoll.ring_allgather(group, xs)
    return getattr(tcoll, call)(group, xs, *case["args"], backend="torch", **kw)


def _bits(t):
    t = t.contiguous()
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()])


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every rank's results at every p: the three groups run together ->
    {p: [rank 0's {name: leaves}, rank 1's, ...]}."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = {}
    for p in PS:
        work = tmp_path_factory.mktemp(f"gloo{p}")
        cases = {k: v for mode in _cases(p).values() for k, v in mode.items()}
        with open(work / "cases.pkl", "wb") as f:
            pickle.dump(cases, f)
        procs[p] = (work, [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(p), str(work)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(p)])
    out, failed = {}, []
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p, (work, ps) in procs.items():
            for r, proc in enumerate(ps):
                _, err = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                if proc.returncode != 0:
                    failed.append(f"p={p} rank {r}:\n{err}")
            if not failed:
                out[p] = []
                for r in range(p):
                    with open(work / f"out{r}.pkl", "rb") as f:
                        out[p].append(pickle.load(f))
    finally:
        for _, ps in procs.values():
            for proc in ps:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    assert not failed, "\n".join(failed)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", PS)
def test_dist_group_matches_stacked_group(ranks_out, p, mode):
    for name, case in _cases(p)[mode].items():
        want = tree_flatten(_stacked(case, p))[0]
        for rank, outs in enumerate(ranks_out[p]):
            got = outs[name]
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                if case["kind"] not in GATHERED and case["call"] not in GATHERED:
                    w = w.reshape(p, -1, *w.shape[1:])[rank]
                assert g.dtype == w.dtype and g.shape == w.shape, (name, rank)
                assert torch.equal(_bits(g), _bits(w)), (name, rank)
