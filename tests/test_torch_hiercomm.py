"""The port's two-level communicator against the JAX package's.

``repro_torch.core.hier.get_hier_comm(StackedGrid(nodes, cores,
device="cpu"))`` holds the nodes x cores ranks as the leading axis of
every payload leaf.  Its oracle is the reference's own
``repro.core.hier.get_hier_comm(mesh, "node", "core", backend="jnp")``
on a forced host mesh, run as ``tests/test_torch_comm.py`` runs the flat
communicator: subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=p`` and
``JAX_PLATFORMS=cpu``, one for each p in {4, 8, 6}, started together
under the lock the port's reference runs share.  The p = 4 process runs
the 2 x 2 grid and the degenerate 1 x 4 and 4 x 1 meshes, the others
2 x 4 and 3 x 2.  The subprocess reads the seeded inputs from a pickle,
runs every case through the reference's plan (jitted, as the reference
always runs it) and writes back the outputs with each plan's block
counts, round counts and statics; bf16 travels as its uint16 bits.

Tolerance: none.  Every case is held bit for bit (floats by their bits,
so NaN payloads and signed zeros count), in both the port's backends
("torch", and "cuda", whose wrappers run the plain versions on CPU
tensors), and the plan's ``n_inter``, ``n_intra``, ``rounds``,
``rounds_inter``, ``rounds_intra`` and statics (every field, the axis
names included) must equal the reference's.

In-process: every exact kind on single-leaf payloads against the
port's ``hier_host_plan`` with the same inputs, the p = 1 identity
against the reference's one-device mesh, the argument and payload error
texts, the block-count resolution at the paper's 36 x 32, plan-cache
identity, and the grids that must raise.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_comm import BF16, _np, _reference_slot, _same_bits, _specials, _to_torch

from repro_torch.core import collectives as tcoll
from repro_torch.core import hier as thier
from repro_torch.core.comm import payload_spec
from repro_torch.core.hier import (
    DistGrid,
    HierComm,
    StackedGrid,
    get_hier_comm,
    hier_host_plan,
)
from repro_torch.core.tree import tree_flatten, tree_unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
#: forced host devices -> the grids its reference process runs
PROCS = {4: [(2, 2), (1, 4), (4, 1)], 8: [(2, 4)], 6: [(3, 2)]}
GRIDS = [g for grids in PROCS.values() for g in grids]
BACKENDS = ("torch", "cuda")
#: the cases the degenerate meshes run (the other grids run them all)
DEGENERATE = ("broadcast_pytree", "reduce_int32", "reduce_f32_max",
              "allreduce_pytree", "allgather_pytree")

RUNNER = r'''
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
import ml_dtypes
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.hier import get_hier_comm

src, dst = sys.argv[1], sys.argv[2]
with open(src, "rb") as f:
    job = pickle.load(f)
results = {}
for (nodes, cores), cases in job.items():
    mesh = Mesh(np.array(jax.devices()[:nodes * cores]).reshape(nodes, cores),
                ("node", "core"))
    hc = get_hier_comm(mesh, "node", "core", backend="jnp")
    sharding = NamedSharding(mesh, P(("node", "core")))
    for case in cases:
        leaves, treedef = jax.tree.flatten(case["payload"])
        leaves = [x.view(ml_dtypes.bfloat16) if i in case["bf16"] else x
                  for i, x in enumerate(leaves)]
        xs = jax.tree.unflatten(treedef, [
            jax.device_put(jnp.asarray(x), sharding) for x in leaves])
        plan = hc.plan(case["kind"], xs, **case["kw"])
        out = []
        for x in jax.tree.leaves(plan(xs)):
            a = np.asarray(x)
            out.append(a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a)
        meta = {k: getattr(plan, k) for k in ("kind", "n_inter", "n_intra", "rounds",
                                              "rounds_inter", "rounds_intra")}
        meta["statics"] = [dict(kind=s.kind, direction=s.direction, p=s.p,
                                root=s.root, n=s.n, nslots=s.nslots,
                                slots=[np.asarray(a) for a in s.slots],
                                ks=np.asarray(s.ks), shifts=tuple(s.shifts),
                                overlap=s.overlap, axis=s.axis)
                           for s in plan.statics]
        results[(nodes, cores, case["name"])] = (out, meta)
with open(dst, "wb") as f:
    pickle.dump(results, f)
'''


# ------------------------------------------------------------------ cases


def _cases(nodes, cores):
    """The seeded cases of a grid: name -> case.  ``payload`` is a NumPy
    tree of global arrays (bf16 leaves as ``ml_dtypes.bfloat16``), ``kw``
    the keyword arguments of both packages' ``plan``."""
    p = nodes * cores
    rng = np.random.default_rng(3000 + 10 * nodes + cores)
    cases = {}

    def add(name, payload, kind, **kw):
        cases[name] = dict(name=name, kind=kind, payload=payload, kw=kw)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def i32(lo, hi, *shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    # mp_worker.check_hier's pytree: mixed f32/int32/bf16, ragged leaves
    tree = {"w": f32(p, 17, 3), "b": i32(0, 100, p, 11),
            "t": (f32(p, 5).astype(BF16),)}
    add("broadcast_pytree", tree, "broadcast", n_inter=2, n_intra=3, root=p - 1)
    add("broadcast_auto_mid_root", f32(p, 97), "broadcast", root=p // 2)
    add("broadcast_int32_root0", i32(-9, 9, p, 41), "broadcast", n_inter=3,
        n_intra=2, root=0)
    add("reduce_int32", {"a": i32(-50, 50, p, 13), "b": i32(-50, 50, p, 7, 2)},
        "reduce", n_inter=1, n_intra=2, root=p // 2)
    add("reduce_int32_wraps", {"a": i32(2 ** 29, 2 ** 31 - 1, p, 17)}, "reduce",
        n_inter=2, n_intra=2, root=p - 1)
    add("reduce_f32_sum_auto", {"a": f32(p, 41), "b": f32(p, 3, 5),
                                "h": f32(p, 9).astype(BF16)}, "reduce", root=p // 2)
    add("reduce_f32_max", {"a": _specials(f32(p, 13)), "b": _specials(f32(p, 7, 2))},
        "reduce", n_inter=2, n_intra=2, root=0, op="max")
    add("allreduce_pytree", tree, "allreduce", n_inter=2, n_intra=1, root=p - 1)
    add("allreduce_max", {"m": _specials(f32(p, 53))}, "allreduce", root=p // 2,
        op="max")
    add("allreduce_int32_auto", [i32(-99, 99, p, 64), None, i32(-9, 9, p, 2, 2)],
        "allreduce")
    add("allgather_pytree", {"x": f32(p * 6), "y": i32(0, 9, p, 4)}, "allgather",
        n_inter=2, n_intra=2)
    add("allgather_bf16_auto", {"h": f32(p * 64).astype(BF16)}, "allgather")
    add("allbroadcast", f32(p * 48), "allbroadcast", n_inter=2, n_intra=3)
    if 1 in (nodes, cores):
        cases = {k: v for k, v in cases.items() if k in DEGENERATE}
    return cases


CASES = [(g, name) for g in GRIDS for name in _cases(*g)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs for every case on every grid: three
    subprocesses, started together -> {(nodes, cores, name): (leaves,
    meta)}."""
    with _reference_slot():
        work = tmp_path_factory.mktemp("hiercomm_reference")
        procs = {}
        for p, grids in PROCS.items():
            job = {}
            for g in grids:
                job[g] = []
                for case in _cases(*g).values():
                    leaves, treedef = tree_flatten(case["payload"])
                    bf16 = [i for i, x in enumerate(leaves) if x.dtype == BF16]
                    job[g].append(dict(case, bf16=bf16, payload=tree_unflatten(
                        treedef, [x.view(np.uint16) if x.dtype == BF16 else x
                                  for x in leaves])))
            src, dst = work / f"in{p}.pkl", work / f"out{p}.pkl"
            with open(src, "wb") as f:
                pickle.dump(job, f)
            env = dict(os.environ)
            env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={p}"
            env["JAX_PLATFORMS"] = "cpu"
            env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
            procs[p] = (subprocess.Popen(
                [sys.executable, "-c", RUNNER, str(src), str(dst)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), dst)
        out = {}
        for p, (proc, dst) in procs.items():
            try:
                _, err = proc.communicate(timeout=110)
            except subprocess.TimeoutExpired:
                for q, _ in procs.values():
                    q.kill()
                raise
            assert proc.returncode == 0, f"reference run at p={p} failed:\n{err}"
            with open(dst, "rb") as f:
                out.update(pickle.load(f))
        return out


def _static_fields(s):
    return (s.kind, s.direction, s.p, s.root, s.n, s.nslots, tuple(s.shifts),
            s.overlap, s.axis)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("grid,name", CASES, ids=[f"{n}x{c}-{k}" for (n, c), k in CASES])
def test_hiercomm_matches_reference(reference, grid, name, backend):
    nodes, cores = grid
    p = nodes * cores
    case = _cases(nodes, cores)[name]
    want, meta = reference[(nodes, cores, name)]
    hc = get_hier_comm(StackedGrid(nodes, cores, device="cpu"), backend=backend)
    xs = _to_torch(case["payload"])
    plan = hc.plan(case["kind"], xs, **case["kw"])
    got = [_np(t) for t in tree_flatten(plan(xs))[0]]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same_bits(g, w), (name, i, g, w)
    if plan.kind == "allgather":
        # every rank's copy of the replicated result, not only the first
        copies = [_np(t) for t in tree_flatten(plan.per_rank(xs))[0]]
        for i, (c, w) in enumerate(zip(copies, want)):
            assert c.shape == (p,) + w.shape, (name, i)
            assert all(_same_bits(c[r], w) for r in range(p)), (name, i)
    assert {k: getattr(plan, k) for k in meta if k != "statics"} == {
        k: v for k, v in meta.items() if k != "statics"}
    assert len(plan.statics) == len(meta["statics"])
    for s, r in zip(plan.statics, meta["statics"]):
        assert _static_fields(s) == (r["kind"], r["direction"], r["p"], r["root"],
                                     r["n"], r["nslots"], r["shifts"], r["overlap"],
                                     r["axis"])
        assert len(s.slots) == len(r["slots"])
        assert all(np.array_equal(a, b) for a, b in zip(s.slots, r["slots"]))
        assert np.array_equal(s.ks, r["ks"])


# ------------------------------------------------- against the host plans


HOST_GRIDS = [(2, 3, 5), (3, 4, 7), (1, 5, 3), (4, 1, 2), (5, 4, 13)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nodes,cores,root", HOST_GRIDS)
def test_every_exact_kind_equals_the_host_plan(nodes, cores, root, backend):
    """One-leaf payloads through each kind, bit for bit against
    ``hier_host_plan`` with the same inputs and block counts: m = 61
    elements a rank splits into padded blocks at both levels."""
    p, m = nodes * cores, 61
    rng = np.random.default_rng(50 + p)
    hc = get_hier_comm(StackedGrid(nodes, cores, device="cpu"), backend=backend)

    def host(kind, nN, nC, **kw):
        return hier_host_plan(kind, nodes, cores, nN, nC, backend=backend,
                              device="cpu", **kw)

    x = torch.from_numpy(rng.normal(size=(p, m)).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(p, m)).astype(np.int32))
    for nN, nC in ((3, 4), (1, 2), (5, 1)):
        out = hc.broadcast(x, n_inter=nN, n_intra=nC, root=root)
        want = host("broadcast", nN, nC, root=root).run(x[root])
        assert torch.equal(out, want.reshape(p, m))
        for op, vals in (("sum", x), ("max", x), ("sum", xi)):
            out = hc.reduce(vals, n_inter=nN, n_intra=nC, root=root, op=op)
            want = host("reduce", nN, nC, root=root, op=op).run(vals)
            assert torch.equal(out[root], want)
            assert not out[:root].any() and not out[root + 1:].any()
            out = hc.allreduce(vals, n_inter=nN, n_intra=nC, root=root, op=op)
            want = host("allreduce", nN, nC, root=root, op=op).run(vals)
            assert torch.equal(out, want.reshape(p, m))
        for vals in (x, xi):
            out = hc.allgather(vals, n_inter=nN, n_intra=nC)
            want = host("allgather", nN, nC).run(vals)
            assert torch.equal(out, want) and torch.equal(out, vals)


@pytest.mark.parametrize("nodes,cores", [(2, 3), (4, 2)])
def test_functional_wrappers_share_the_plan_cache(nodes, cores):
    grid = StackedGrid(nodes, cores, device="cpu")
    p = grid.p
    x = torch.arange(p * 7, dtype=torch.float32).view(p, 7)
    hc = get_hier_comm(grid, backend="torch")
    for fn, kw in ((tcoll.hier_broadcast, {"root": p - 1}),
                   (tcoll.hier_reduce, {"root": 1, "op": "max"}),
                   (tcoll.hier_allreduce, {}), (tcoll.hier_allgather, {})):
        a = fn(grid, x, n_inter=2, n_intra=2, backend="torch", **kw)
        b = getattr(hc, fn.__name__.removeprefix("hier_"))(x, n_inter=2, n_intra=2, **kw)
        assert torch.equal(a, b)
    assert torch.equal(tcoll.hier_allreduce(grid, x, backend="torch"),
                       x.sum(0).expand(p, 7))


# -------------------------------------------------------------- in-process


def _mesh11():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("node", "core"))


def test_p1_is_the_identity_as_in_the_reference():
    from repro.core.hier import get_hier_comm as ref_get_hier_comm

    ref = ref_get_hier_comm(_mesh11(), "node", "core")
    hc = get_hier_comm(StackedGrid(1, 1, device="cpu"), backend="torch")
    state = {"w": np.arange(12, dtype=np.float32).reshape(1, 12),
             "b": (np.arange(5, dtype=np.int32).reshape(1, 5),)}
    tstate = _to_torch(state)
    for kind in ("broadcast", "reduce", "allreduce", "allgather", "allbroadcast"):
        for n in (None, 3):
            rp = ref.plan(kind, state, n_inter=n, n_intra=n)
            tp = hc.plan(kind, tstate, n_inter=n, n_intra=n)
            fields = ("kind", "p", "n_inter", "n_intra", "rounds", "rounds_inter",
                      "rounds_intra", "root", "op", "statics")
            assert {f: getattr(tp, f) for f in fields} == {
                f: getattr(rp, f) for f in fields}
            assert tp(tstate) is tstate
            assert tp.describe().replace("torch", "jnp") == rp.describe()
    assert hc.plan("allgather", tstate).per_rank(tstate)["w"].shape == (1, 1, 12)


def _texts(fn_ref, fn_port):
    with pytest.raises(ValueError) as r:
        fn_ref()
    with pytest.raises(ValueError) as t:
        fn_port()
    return str(r.value), str(t.value)


def test_argument_and_payload_errors_match_the_reference():
    from repro.core import hier as rhier

    mesh = _mesh11()
    ref = rhier.get_hier_comm(mesh, "node", "core")
    hc = get_hier_comm(StackedGrid(1, 1, device="cpu"), backend="torch")
    x = {"a": np.zeros((1, 8), np.float32)}
    for kind, spec, kw in (("gossip", x, {}), ("allgather", x, {"root": 1}),
                           ("allbroadcast", x, {"op": "max"}),
                           ("broadcast", x, {"op": "max"}),
                           ("broadcast", x, {"root": 7}),
                           ("reduce", x, {"root": -1}),
                           ("broadcast", {"a": None}, {})):
        r, t = _texts(lambda: ref.plan(kind, spec, **kw),
                      lambda: hc.plan(kind, _to_torch(spec), **kw))
        assert r == t, kind
    with pytest.raises(ValueError, match="unsupported reduction op"):
        hc.plan("reduce", _to_torch(x), op="min")
    rp, tp = ref.plan("broadcast", x), hc.plan("broadcast", _to_torch(x))
    for bad in ({"b": np.zeros((1, 8), np.float32)},
                {"a": np.zeros((1, 9), np.float32)},
                {"a": np.zeros((1, 8), np.int32)}):
        r, t = _texts(lambda: rp(bad), lambda: tp(_to_torch(bad)))
        assert r == t
    # the communicator's own checks: equal axes, an unknown backend
    r, t = _texts(
        lambda: rhier.HierComm(mesh=mesh, inter_axis="node", intra_axis="node"),
        lambda: HierComm(StackedGrid(1, 1, device="cpu", intra_axis="node")))
    assert r == t
    r, t = _texts(
        lambda: rhier.HierComm(mesh=mesh, inter_axis="node", intra_axis="core",
                               backend="bogus"),
        lambda: HierComm(StackedGrid(1, 1, device="cpu"), backend="bogus"))
    assert r.replace("('jnp', 'pallas')", "('torch', 'cuda')") == t
    # the block resolver's shape checks, on a 2 x 2 grid's specs
    md = rhier.DEFAULT_MODEL
    for kind in ("broadcast", "allgather"):
        for a in (np.zeros((3, 4), np.float32), np.zeros((6,), np.float32)):
            rs, ts = rhier.payload_spec({"a": a}), payload_spec(_to_torch({"a": a}))
            try:
                want = ("ok", rhier._resolve_hier_blocks(kind, rs, 2, 2, None, None,
                                                         md, md))
            except ValueError as e:
                want = ("raises", str(e))
            try:
                got = ("ok", thier._resolve_hier_blocks(kind, ts, 2, 2, None, None,
                                                        thier.DEFAULT_MODEL,
                                                        thier.DEFAULT_MODEL))
            except ValueError as e:
                got = ("raises", str(e))
            assert got == want, (kind, a.shape)


def test_block_counts_match_the_reference_at_36x32():
    """The smoke run's payloads: (41, 37) for the 16 MiB broadcast,
    reduce and allreduce, (30, 5) for the 8 KiB allgather, and the
    communicator's pytree, each also with one level given."""
    from repro.core import hier as rhier

    md = rhier.DEFAULT_MODEL
    p = 36 * 32
    cases = [("broadcast", {"x": ((p, 4 << 20), np.float32)}),
             ("reduce", {"x": ((p, 4 << 20), np.float32)}),
             ("allreduce", {"w": ((p, 3 << 20), np.float32),
                            "b": ((p, 1 << 20), np.int32)}),
             ("allgather", {"a": ((p * 2048,), np.float32)}),
             ("allgather", {"a": ((p * 4, 3), np.int32), "h": ((p, 5), np.float32)})]
    for kind, shapes in cases:
        rs = rhier.payload_spec({k: jax.ShapeDtypeStruct(s, dt)
                                 for k, (s, dt) in shapes.items()})
        ts = payload_spec({k: torch.empty(s, device="meta", dtype=torch.float32
                                          if dt == np.float32 else torch.int32)
                           for k, (s, dt) in shapes.items()})
        for given in ((None, None), (7, None), (None, 3)):
            want = rhier._resolve_hier_blocks(kind, rs, 36, 32, *given, md, md)
            got = thier._resolve_hier_blocks(kind, ts, 36, 32, *given,
                                             thier.DEFAULT_MODEL, thier.DEFAULT_MODEL)
            assert got == want, (kind, given)
    big = payload_spec({"x": torch.empty((p, 4 << 20), device="meta")})
    gather = payload_spec({"a": torch.empty((p * 2048,), device="meta")})
    assert thier._resolve_hier_blocks("broadcast", big, 36, 32, None, None,
                                      thier.DEFAULT_MODEL, thier.DEFAULT_MODEL) == (41, 37)
    assert thier._resolve_hier_blocks("allgather", gather, 36, 32, None, None,
                                      thier.DEFAULT_MODEL, thier.DEFAULT_MODEL) == (30, 5)


def test_plan_cache_identity_and_kind_canonicalization():
    grid = StackedGrid(2, 3, device="cpu")
    hc = get_hier_comm(grid, backend="torch")
    assert hc is get_hier_comm(StackedGrid(2, 3, device="cpu"), backend="torch")
    assert hc is not get_hier_comm(grid, backend="cuda")
    assert hc is not get_hier_comm(StackedGrid(2, 3, device="cpu", inter_axis="rack"),
                                   backend="torch")
    x = {"a": torch.zeros((6, 8))}
    p1 = hc.plan("broadcast", x, n_inter=2, n_intra=2, root=4)
    assert p1 is hc.plan("broadcast", x, n_inter=2, n_intra=2, root=4)
    assert p1 is hc.plan("broadcast", payload_spec(x), n_inter=2, n_intra=2, root=4)
    auto = hc.plan("reduce", x, root=4, op="max")
    assert hc.plan("reduce", x, n_inter=auto.n_inter, n_intra=auto.n_intra, root=4,
                   op="max") is auto
    g = torch.zeros((12, 3))
    assert hc.plan("allbroadcast", g) is hc.plan("allgather", g)
    assert hc.plan("allbroadcast", g).kind == "allgather"
    assert "op=max" in auto.describe() and "mesh=2x3" in auto.describe()
    with pytest.raises(ValueError, match="per_rank applies to allgather"):
        p1.per_rank(x)


@pytest.mark.parametrize("kind", ["broadcast", "reduce", "allreduce", "allgather"])
def test_leaves_off_the_grid_device_raise(kind):
    hc = get_hier_comm(StackedGrid(2, 2, device="cpu"), backend="torch")
    good = {"a": torch.zeros((4, 6)), "b": torch.zeros((4, 3), dtype=torch.int32)}
    bad = {"a": torch.zeros((4, 6), device="meta"), "b": good["b"]}
    plan = hc.plan(kind, good)
    assert plan(good) is not None
    with pytest.raises(ValueError, match="leaf 0 is on meta, the group's "
                                         "ranks are on cpu"):
        plan(bad)


def test_grids_raise_without_a_card_or_a_process_group(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedGrid(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedGrid(2, 2, device="cuda")
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistGrid(2, 2)
    with pytest.raises(ValueError, match="nodes, cores >= 1"):
        StackedGrid(0, 2, device="cpu")


def test_dist_grid_takes_gloo_only(monkeypatch):
    """An nccl group is refused, and so is a group of the wrong size; the
    process group is faked, none is started in this process."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 6)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="gloo only, not 'nccl'"):
        DistGrid(2, 3)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(ValueError, match="a 2x2 grid needs 4 processes, the "
                                         "group has 6"):
        DistGrid(2, 2)
