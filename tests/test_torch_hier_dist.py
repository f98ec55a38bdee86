"""The two-level communicator over ``torch.distributed``: ``DistGrid`` on gloo.

On the 2 x 2 and 2 x 3 grids, 4 + 6 fresh interpreters (``subprocess``,
never a fork of this process) join one gloo group each through a
``file://`` rendezvous in ``tmp_path``, make the grid's node and
core-column subgroups and run every kind of ``get_hier_comm(DistGrid(
nodes, cores))`` as ranks: broadcast, reduce (sum, max, a wrapping int32
sum), allreduce and allgather (and its alias allbroadcast) on mixed-dtype
pytrees, roots 0, p - 1 and a middle one, block counts given and
resolved.  Each rank passes its own shard of the seeded global payload
and writes what it got back.  Every rank's result must equal, bit for
bit, the same call's result on a ``StackedGrid`` in this process (its
row of it, or all of it for the allgathers, whose result every rank
holds; a worker also checks that ``plan.per_rank`` gives its one copy).

The workers import ``repro_torch`` only; this process never initializes
a process group.  Both grids run together, 10 processes, each with one
thread.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core.hier import StackedGrid, get_hier_comm
from repro_torch.core.tree import tree_flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
GRIDS = [(2, 2), (2, 3)]
TIMEOUT_S = 100

WORKER = r'''
import pickle, sys
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.core.hier import DistGrid, get_hier_comm
from repro_torch.core.tree import tree_flatten, tree_unflatten

rank, nodes, cores, work = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4])
p = nodes * cores
dist.init_process_group("gloo", init_method=f"file://{work}/store", rank=rank,
                        world_size=p, timeout=timedelta(seconds=60))
try:
    with open(f"{work}/cases.pkl", "rb") as f:
        cases = pickle.load(f)
    grid = DistGrid(nodes, cores)
    assert (grid.p, grid.rank, grid.ranks) == (p, rank, range(rank, rank + 1))
    assert (grid.inter.p, grid.inter.rank) == (nodes, rank // cores)
    assert (grid.intra.p, grid.intra.rank) == (cores, rank % cores)
    hc = get_hier_comm(grid, backend="torch")
    outs = {}
    for name, case in cases.items():
        leaves, treedef = tree_flatten(case["payload"])
        mine = tree_unflatten(treedef, [
            x.view(p, -1, *x.shape[1:])[rank].clone() for x in leaves])
        plan = hc.plan(case["kind"], mine, **case["kw"])
        out = plan(mine)
        if plan.kind == "allgather":
            for c, o in zip(tree_flatten(plan.per_rank(mine))[0],
                            tree_flatten(out)[0]):
                assert c.shape == (1,) + o.shape and torch.equal(c[0], o), name
        outs[name] = (tree_flatten(out)[0], plan.n_inter, plan.n_intra)
    with open(f"{work}/out{rank}.pkl", "wb") as f:
        pickle.dump(outs, f)
finally:
    dist.destroy_process_group()
'''


def _cases(nodes, cores):
    """name -> case: a tree of global tensors (one slice a rank along the
    leading axis), the kind and the plan's keyword arguments."""
    p = nodes * cores
    rng = np.random.default_rng(4000 + 10 * nodes + cores)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def i32(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.int32))

    tree = {"w": f32(p, 17, 3), "b": i32(0, 100, p, 11),
            "t": (f32(p, 5).to(torch.bfloat16),)}
    data = {"a": i32(-50, 50, p, 13), "b": i32(-50, 50, p, 7, 2)}
    return {
        "broadcast_pytree": dict(payload=tree, kind="broadcast",
                                 kw=dict(n_inter=2, n_intra=3, root=p - 1)),
        "broadcast_auto": dict(payload={"x": f32(p, 97)}, kind="broadcast",
                               kw=dict(root=p // 2)),
        "reduce_int32": dict(payload=data, kind="reduce",
                             kw=dict(n_inter=1, n_intra=2, root=p // 2)),
        "reduce_wraps": dict(payload={"a": i32(2 ** 29, 2 ** 31 - 1, p, 17)},
                             kind="reduce", kw=dict(n_inter=2, n_intra=2, root=0)),
        "reduce_max": dict(payload={"a": f32(p, 13), "b": f32(p, 7, 2)}, kind="reduce",
                           kw=dict(root=p - 1, op="max")),
        "allreduce_pytree": dict(payload=tree, kind="allreduce",
                                 kw=dict(n_inter=2, n_intra=1, root=p - 1)),
        "allreduce_auto": dict(payload=data, kind="allreduce", kw={}),
        "allgather_pytree": dict(payload={"x": f32(p * 6), "y": i32(0, 9, p, 4)},
                                 kind="allgather", kw=dict(n_inter=2, n_intra=2)),
        "allbroadcast": dict(payload={"h": f32(p * 64).to(torch.bfloat16)},
                             kind="allbroadcast", kw={}),
    }


def _bits(t):
    t = t.contiguous()
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()])


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every rank's results on every grid, both grids at once ->
    {(nodes, cores): [rank 0's {name: (leaves, n_inter, n_intra)}, ...]}."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = {}
    for nodes, cores in GRIDS:
        work = tmp_path_factory.mktemp(f"gloo{nodes}x{cores}")
        with open(work / "cases.pkl", "wb") as f:
            pickle.dump(_cases(nodes, cores), f)
        procs[(nodes, cores)] = (work, [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(nodes), str(cores), str(work)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(nodes * cores)])
    out, failed = {}, []
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for grid, (work, ps) in procs.items():
            for r, proc in enumerate(ps):
                _, err = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                if proc.returncode != 0:
                    failed.append(f"grid {grid} rank {r}:\n{err}")
            if not failed:
                out[grid] = []
                for r in range(len(ps)):
                    with open(work / f"out{r}.pkl", "rb") as f:
                        out[grid].append(pickle.load(f))
    finally:
        for _, ps in procs.values():
            for proc in ps:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    assert not failed, "\n".join(failed)
    return out


@pytest.mark.parametrize("name", list(_cases(2, 2)))
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{n}x{c}" for n, c in GRIDS])
def test_dist_grid_matches_stacked_grid(ranks_out, grid, name):
    nodes, cores = grid
    p = nodes * cores
    case = _cases(nodes, cores)[name]
    plan = get_hier_comm(StackedGrid(nodes, cores, device="cpu"),
                         backend="torch").plan(case["kind"], case["payload"], **case["kw"])
    want = tree_flatten(plan(case["payload"]))[0]
    for rank, outs in enumerate(ranks_out[grid]):
        got, n_inter, n_intra = outs[name]
        assert (n_inter, n_intra) == (plan.n_inter, plan.n_intra), (name, rank)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            if plan.kind != "allgather":
                w = w.reshape(p, -1, *w.shape[1:])[rank]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, rank)
            assert torch.equal(_bits(g), _bits(w)), (name, rank)
