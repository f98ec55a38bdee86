"""The port's plan/execute communicator against the JAX package's.

``repro_torch.core.comm.get_comm(StackedGroup(p, device="cpu"))`` holds
the p ranks as the leading axis of every payload leaf.  Its oracle is the
reference's own ``repro.core.comm.CirculantComm`` on a p-device host
mesh, run the way ``tests/conftest.py:run_worker`` runs
``tests/mp_worker.py``: a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=p`` and
``JAX_PLATFORMS=cpu`` (so this process keeps its one-device view), one
for each p in {2, 5, 8}, all three started together.  The subprocess
reads the seeded inputs from a pickle, runs every case through the
reference's plan (jitted, as the reference always runs it), its shims or
its ``broadcast_state``, and writes back the outputs with each plan's
``n_blocks``, ``rounds`` and statics; bf16 travels as its uint16 bits,
and int64 cases run under the scoped ``jax.enable_x64(True)``.

Tolerance: none.  Every case is held bit for bit (floats by their bits,
so NaN payloads and signed zeros count), in both the port's backends
("torch", and "cuda", whose wrappers run the plain versions on CPU
tensors after checking the operands), and the plan's ``n_blocks``,
``rounds`` and statics must equal the reference's (every field of a
``PhaseStatic`` but ``axis``: the port names no mesh axis).

In-process: the p = 1 identity against the reference's one-device mesh,
the spec and argument error texts, plan-cache identity, leaf order and
``PyTreeDef`` text against ``jax.tree``, and the entry points that must
raise.  Nothing here clears the reference's plan cache or sets JAX's
global config.
"""

import contextlib
import fcntl
import os
import pickle
import subprocess
import sys
import tempfile
from collections import OrderedDict, defaultdict, namedtuple

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.core import collectives as tcoll
from repro_torch.core import comm as tcomm
from repro_torch.core.comm import DistGroup, StackedGroup, get_comm
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.train.restore_broadcast import broadcast_state, restore_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PS = (2, 5, 8)
BACKENDS = ("torch", "cuda")
BF16 = ml_dtypes.bfloat16
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}

RUNNER = r'''
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
import ml_dtypes
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core import collectives
from repro.core.comm import get_comm
from repro.train.restore_broadcast import broadcast_state

src, dst = sys.argv[1], sys.argv[2]
with open(src, "rb") as f:
    job = pickle.load(f)
p = job["p"]
mesh = Mesh(np.array(jax.devices()[:p]), ("data",))
comm = get_comm(mesh, "data")


def to_jax(tree, bf16):
    leaves, treedef = jax.tree.flatten(tree)
    leaves = [x.view(ml_dtypes.bfloat16) if i in bf16 else x
              for i, x in enumerate(leaves)]
    return jax.tree.unflatten(treedef, [
        jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
        for x in leaves])


def from_jax(tree):
    out = []
    for x in jax.tree.leaves(tree):
        a = np.asarray(x)
        out.append(a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a)
    return out


def run(case):
    xs = to_jax(case["payload"], case["bf16"])
    call, kw = case["call"], case["kw"]
    if call == "plan":
        plan = comm.plan(case["kind"], xs, **kw)
        meta = {"n_blocks": plan.n_blocks, "rounds": plan.rounds,
                "statics": [dict(kind=s.kind, direction=s.direction, p=s.p,
                                 root=s.root, n=s.n, nslots=s.nslots,
                                 slots=[np.asarray(a) for a in s.slots],
                                 ks=np.asarray(s.ks), shifts=tuple(s.shifts),
                                 overlap=s.overlap) for s in plan.statics]}
        return from_jax(plan(xs)), meta
    if call == "broadcast_state":
        return from_jax(broadcast_state(mesh, "data", xs, **kw)), {}
    return from_jax(getattr(collectives, call)(mesh, "data", xs, *case["args"],
                                               **kw)), {}


results = {}
for case in job["cases"]:
    if case["x64"]:
        with jax.enable_x64(True):
            results[case["name"]] = run(case)
    else:
        results[case["name"]] = run(case)
with open(dst, "wb") as f:
    pickle.dump(results, f)
'''


# ------------------------------------------------------------------ cases


def _specials(a):
    """+-0 and NaN at fixed places of a float array (max's hard cases)."""
    f = a.reshape(-1)
    f[0::7] = np.nan
    f[2::5] = -0.0
    f[3::5] = 0.0
    return a


def _cases(p):
    """The seeded cases at p: name -> case.  ``payload`` is a NumPy tree
    (bf16 leaves as ``ml_dtypes.bfloat16``), ``kw`` the keyword arguments
    of both packages' call; ``call`` is ``"plan"`` (``comm.plan(kind,
    payload, **kw)(payload)``), ``"broadcast_state"`` or a shim's name."""
    rng = np.random.default_rng(1000 + p)
    cases = {}

    def add(name, payload, kind=None, call="plan", args=(), x64=False, **kw):
        cases[name] = dict(name=name, kind=kind, payload=payload, call=call,
                           args=list(args), x64=x64, kw=kw)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def i32(lo, hi, *shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    # check_comm's pytree: a dict with a tuple leaf, mixed f32/int32/bf16,
    # ragged leaves (111, 11 and 5 elements in 4 blocks), a nonzero root
    tree = {"w": f32(p, 37, 3), "b": i32(0, 100, p, 11),
            "t": (f32(p, 5).astype(BF16),)}
    for ov in (False, True):
        tag = "_overlap" if ov else ""
        add("broadcast_pytree" + tag, tree, "broadcast", n_blocks=4,
            root=p - 1, overlap=ov)
        add("reduce_int32" + tag, {"a": i32(-50, 50, p, 13),
                                   "b": i32(-50, 50, p, 7, 2)},
            "reduce", n_blocks=3, root=1, overlap=ov)
        add("reduce_int32_wraps" + tag, {"a": i32(2 ** 29, 2 ** 31 - 1, p, 17)},
            "reduce", n_blocks=2, root=p // 2, overlap=ov)
        add("reduce_int64" + tag, {"a": rng.integers(2 ** 60, 2 ** 62, size=(p, 19))},
            "reduce", x64=True, n_blocks=2, root=p - 1, overlap=ov)
        add("reduce_f32_sum" + tag, {"a": f32(p, 41), "b": f32(p, 3, 5)},
            "reduce", n_blocks=5, root=p - 1, overlap=ov)
        add("reduce_f32_max" + tag, {"a": _specials(f32(p, 13)),
                                     "b": _specials(f32(p, 7, 2))},
            "reduce", n_blocks=3, root=0, op="max", overlap=ov)
        add("allreduce_int32" + tag, {"a": i32(-50, 50, p, 13),
                                      "b": i32(-50, 50, p, 7, 2)},
            "allreduce", n_blocks=2, overlap=ov)
        add("allreduce_f32_max" + tag, {"m": _specials(f32(p, 53))},
            "allreduce", n_blocks=1, root=p // 2, op="max", overlap=ov)
        add("allreduce_f32_sum" + tag, tree, "allreduce", n_blocks=3,
            root=p - 1, overlap=ov)
        add("allgather_pytree" + tag, {"x": f32(p * 6), "y": i32(0, 9, p, 4)},
            "allgather", n_blocks=3, overlap=ov)
        add("allgather_bf16" + tag, {"h": f32(p * 64).astype(BF16)},
            "allgather", overlap=ov)
        add("allbroadcast" + tag, f32(p * 48), "allbroadcast", n_blocks=3,
            overlap=ov)
        add("reduce_scatter_f32" + tag, {"m": f32(p, p * 8)}, "reduce_scatter",
            n_blocks=2, overlap=ov)
        add("reduce_scatter_int32" + tag,
            {"m": (rng.integers(-1000, 1000, size=(p, p * 8))
                   * 100003).astype(np.int32)},
            "reduce_scatter", n_blocks=3, overlap=ov)
        add("reduce_scatter_bf16" + tag, {"m": f32(p, p * 24).astype(BF16),
                                          "f": f32(p, p * 3)},
            "reduce_scatter", n_blocks=3, overlap=ov)
    add("broadcast_auto", f32(p, 97), "broadcast", root=p // 2)
    add("broadcast_int32_n1", i32(-9, 9, p, 97), "broadcast", n_blocks=1)
    add("reduce_auto", {"a": f32(p, 300)}, "reduce", root=p - 1)
    add("allreduce_auto", [f32(p, 64), None, i32(-9, 9, p, 2, 2)], "allreduce")
    add("reduce_scatter_auto", f32(p, p * 40), "reduce_scatter")

    sizes = {"u": [3 * j + 1 for j in range(p)], "v": [7] * p}
    vin = {"u": np.zeros((p, 3 * p), np.int32), "v": np.zeros((p, 9), np.float32)}
    for j in range(p):
        vin["u"][j, :sizes["u"][j]] = rng.integers(1, 99, size=sizes["u"][j])
        vin["v"][j, :7] = rng.normal(size=7)
    add("allgatherv_sizes_tree", vin, "allgatherv", n_blocks=2, sizes=sizes)
    add("allgatherv_shared", {"v": vin["v"]}, "allgatherv", n_blocks=2,
        sizes=[7] * p)
    # two leaves whose roots fall into the same block sizes, with the
    # sizes swapped inside each block size
    alike = {"u": [4 + j for j in range(p)]}
    groups = {}
    for j, s in enumerate(alike["u"]):
        groups.setdefault(-(-s // 2), []).append(j)
    alike["v"] = list(alike["u"])
    for roots in groups.values():
        for j, k in zip(roots, reversed(roots)):
            alike["v"][j] = alike["u"][k]
    add("allgatherv_sizes_alike", {"u": i32(-99, 99, p, p + 4),
                                   "v": f32(p, p + 4)}, "allgatherv",
        n_blocks=2, sizes=alike)
    degenerate = [600] + [1] * (p - 1)
    rows = np.zeros((p, 600), np.int32)
    for j, s in enumerate(degenerate):
        rows[j, :s] = rng.integers(0, 1000, size=s)
    add("allgatherv_degenerate", rows, "allgatherv", n_blocks=3,
        sizes=degenerate)
    ragged = [int(s) for s in rng.integers(0, 50, size=p)]
    ragged[p // 2] = 0
    rows = rng.integers(-1000, 1000, size=(p, 50)).astype(np.int32)
    add("allgatherv_ragged_with_a_zero", rows, "allgatherv", sizes=ragged)

    state = {"w": f32(p, 33, 7), "b": f32(p, 13), "step": i32(0, 99, p),
             "h": (f32(p, 9).astype(BF16), None)}
    add("broadcast_state", state, call="broadcast_state", n_blocks=3)
    add("broadcast_state_auto_root", state, call="broadcast_state",
        root=p - 1)

    arr = f32(p, 37, 3)
    add("shim_broadcast", arr, call="circulant_broadcast", n_blocks=4,
        root=p - 1)
    add("shim_allgather", f32(p * 6), call="circulant_allgather", n_blocks=2)
    add("shim_allbroadcast", f32(p * 6), call="circulant_allbroadcast")
    add("shim_allgatherv", vin["u"], call="circulant_allgatherv",
        args=[sizes["u"]], n_blocks=2)
    add("shim_reduce_scatter", f32(p, p * 6), call="circulant_reduce_scatter",
        n_blocks=3)
    add("shim_reduce", _specials(f32(p, 41)), call="circulant_reduce",
        n_blocks=3, root=p - 1, op="max")
    add("shim_allreduce", i32(-99, 99, p, 53), call="circulant_allreduce",
        n_blocks=2)
    add("ring_allgather", np.arange(p * 16, dtype=np.float32),
        call="ring_allgather")
    return cases


def _to_torch(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        if x.dtype == BF16 else torch.from_numpy(x.copy()) for x in leaves])


def _np(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _same_bits(got, want):
    return (got.shape == want.shape and got.dtype == want.dtype
            and np.array_equal(got.view(_UINT[got.dtype.itemsize]),
                               want.view(_UINT[want.dtype.itemsize])))


# --------------------------------------------------------------- reference


@contextlib.contextmanager
def _reference_slot():
    """Hold the lock the port's reference-run fixtures share (a file in
    the temporary directory), so that one set of JAX reference processes
    loads the cores at a time when the test files run in parallel."""
    path = os.path.join(tempfile.gettempdir(), "repro_torch_reference_runs.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs for every case at every p: three
    subprocesses, started together -> {p: {name: (leaves, meta)}}."""
    with _reference_slot():
        work = tmp_path_factory.mktemp("comm_reference")
        procs = {}
        for p in PS:
            cases = []
            for case in _cases(p).values():
                leaves, treedef = tree_flatten(case["payload"])
                bf16 = [i for i, x in enumerate(leaves) if x.dtype == BF16]
                cases.append(dict(case, bf16=bf16, payload=tree_unflatten(
                    treedef, [x.view(np.uint16) if x.dtype == BF16 else x
                              for x in leaves])))
            src, dst = work / f"in{p}.pkl", work / f"out{p}.pkl"
            with open(src, "wb") as f:
                pickle.dump({"p": p, "cases": cases}, f)
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
                out[p] = pickle.load(f)
        return out


def _run_port(case, p, backend):
    group = StackedGroup(p, device="cpu")
    xs = _to_torch(case["payload"])
    call, kw = case["call"], case["kw"]
    if call == "plan":
        plan = get_comm(group, backend=backend).plan(case["kind"], xs, **kw)
        return plan(xs), plan
    if call == "broadcast_state":
        return broadcast_state(group, xs, backend=backend, **kw), None
    if call == "ring_allgather":
        return tcoll.ring_allgather(group, xs), None
    return getattr(tcoll, call)(group, xs, *case["args"], backend=backend,
                                **kw), None


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("p,name", [(p, name) for p in PS for name in _cases(p)])
def test_comm_matches_reference(reference, p, name, backend):
    case = _cases(p)[name]
    want, meta = reference[p][name]
    out, plan = _run_port(case, p, backend)
    got = [_np(t) for t in tree_flatten(out)[0]]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same_bits(g, w), (name, i, g, w)
    if plan is not None and plan.kind in ("allgather", "allgatherv"):
        # every rank's copy of the replicated result, not only the first
        copies = [_np(t) for t in tree_flatten(plan.per_rank(_to_torch(
            case["payload"])))[0]]
        for i, (c, w) in enumerate(zip(copies, want)):
            assert c.shape == (p,) + w.shape, (name, i)
            assert all(_same_bits(c[r], w) for r in range(p)), (name, i)
    if plan is not None:
        assert (plan.n_blocks, plan.rounds) == (meta["n_blocks"], meta["rounds"])
        assert len(plan.statics) == len(meta["statics"])
        for s, r in zip(plan.statics, meta["statics"]):
            assert (s.kind, s.direction, s.p, s.root, s.n, s.nslots,
                    tuple(s.shifts), s.overlap) == (
                r["kind"], r["direction"], r["p"], r["root"], r["n"],
                r["nslots"], r["shifts"], r["overlap"])
            assert len(s.slots) == len(r["slots"])
            assert all(np.array_equal(a, b) for a, b in zip(s.slots, r["slots"]))
            assert np.array_equal(s.ks, r["ks"])


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("overlap", [False, True])
def test_int64_reduce_scatter_sums_exactly_and_wraps(p, overlap):
    """int64 partials accumulate natively.  (The reference's own
    reduce_scatter cannot take int64: under x64 its ``dynamic_slice``
    mixes an int32 rank index with int64 offsets and raises TypeError.)"""
    rng = np.random.default_rng(7 + p)
    m = rng.integers(2 ** 60, 2 ** 62, size=(p, p * 5))
    with np.errstate(over="ignore"):
        want = m.sum(0).reshape(p, 5)
    comm = get_comm(StackedGroup(p, device="cpu"), backend="torch")
    got = comm.reduce_scatter({"m": torch.from_numpy(m)}, n_blocks=2,
                              overlap=overlap)["m"]
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", PS)
def test_overlap_plans_are_distinct_and_bit_exact(p):
    """check_overlap: the overlapped plan is a plan of its own, equal bit
    for bit to the sequential one."""
    comm = get_comm(StackedGroup(p, device="cpu"), backend="torch")
    rng = np.random.default_rng(43)
    xs = {"w": torch.from_numpy(rng.normal(size=(p, 37)).astype(np.float32)),
          "b": torch.from_numpy(rng.integers(-9, 9, size=(p, 11)).astype(np.int32))}
    for kind in ("broadcast", "allgather", "reduce", "allreduce"):
        kw = dict(n_blocks=3, root=p - 1 if kind in ("broadcast", "reduce") else 0)
        seq = comm.plan(kind, xs, **kw)
        ovl = comm.plan(kind, xs, overlap=True, **kw)
        assert ovl is not seq and ovl.overlap and not seq.overlap
        a, b = seq(xs), ovl(xs)
        assert all(torch.equal(a[k], b[k]) for k in xs)
    with pytest.raises(ValueError, match="overlap"):
        comm.plan("allgatherv", xs, sizes=[1] * p, overlap=True)


# -------------------------------------------------------------- in-process


def _mesh1():
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("data",))


def test_p1_is_the_identity_as_in_the_reference():
    from repro.core.comm import get_comm as ref_get_comm

    ref = ref_get_comm(_mesh1(), "data")
    comm = get_comm(StackedGroup(1, device="cpu"), backend="torch")
    state = {"w": np.arange(12, dtype=np.float32).reshape(1, 12),
             "b": (np.arange(5, dtype=np.int32).reshape(1, 5),)}
    tstate = _to_torch(state)
    for kind, kw in (("broadcast", {}), ("reduce", {}), ("allreduce", {}),
                     ("allgather", {}), ("reduce_scatter", {}),
                     ("allgatherv", {"sizes": [3]})):
        for n in (None, 3):
            rp = ref.plan(kind, state, n_blocks=n, **kw)
            tp = comm.plan(kind, tstate, n_blocks=n, **kw)
            assert (tp.p, tp.n_blocks, tp.rounds, tp.root, tp.statics) == (
                rp.p, rp.n_blocks, rp.rounds, rp.root, rp.statics)
            assert tp(tstate) is tstate
    # wrong-length sizes fail on the fast path too, with the same text
    for c, x in ((ref, {"v": np.zeros((1, 4), np.float32)}),
                 (comm, {"v": torch.zeros((1, 4))})):
        with pytest.raises(ValueError, match="length p=1, got 2"):
            c.allgatherv(x, [4, 4])


def _texts(fn_ref, fn_port):
    """The ValueError texts of the reference's call and the port's."""
    with pytest.raises(ValueError) as r:
        fn_ref()
    with pytest.raises(ValueError) as t:
        fn_port()
    return str(r.value), str(t.value)


def test_payload_spec_and_validation_texts_match_the_reference():
    from repro.core.comm import get_comm as ref_get_comm
    from repro.core.comm import payload_spec as ref_spec

    from repro_torch.core.comm import payload_spec

    tree = {"w": np.zeros((4, 3), np.float32), "b": (np.zeros((4,), np.int32),)}
    s1 = payload_spec(_to_torch(tree))
    s2 = payload_spec({"w": torch.empty((4, 3), device="meta"),
                       "b": (torch.empty((4,), dtype=torch.int32, device="meta"),)})
    assert s1 == s2 and hash(s1) == hash(s2) and payload_spec(s1) is s1
    assert s1.num_leaves == 2
    assert s1.describe() == ref_spec(tree).describe()
    assert payload_spec(_to_torch({"w": tree["w"].astype(np.float64),
                                   "b": tree["b"]})) != s1

    ref = ref_get_comm(_mesh1(), "data")
    comm = get_comm(StackedGroup(1, device="cpu"), backend="torch")
    x = {"a": np.zeros((1, 8), np.float32)}
    rp, tp = ref.plan("broadcast", x, n_blocks=2), comm.plan("broadcast",
                                                             _to_torch(x), n_blocks=2)
    for bad in ({"b": np.zeros((1, 8), np.float32)},
                {"a": np.zeros((1, 9), np.float32)},
                {"a": np.zeros((1, 8), np.int32)},
                {"a": (np.zeros((1, 8), np.float32),)}):
        r, t = _texts(lambda: rp(bad), lambda: tp(_to_torch(bad)))
        assert r == t


def test_plan_argument_errors_match_the_reference():
    from repro.core import comm as rcomm

    from repro_torch.core.costmodel import DEFAULT_MODEL, optimal_num_blocks_bcast
    from repro_torch.core.comm import payload_spec

    ref = rcomm.get_comm(_mesh1(), "data")
    comm = get_comm(StackedGroup(1, device="cpu"), backend="torch")
    x = {"a": np.zeros((1, 8), np.float32)}
    g = np.zeros((1, 8), np.float32)
    for kind, spec, kw in (("gossip", x, {}), ("allgather", g, {"root": 1}),
                           ("broadcast", x, {"op": "max"}),
                           ("reduce_scatter", x, {"op": "max"}),
                           ("reduce", x, {"sizes": [1]}),
                           ("allreduce", x, {"qblock": 8}),
                           ("allgatherv", x, {"sizes": [1], "overlap": True}),
                           ("allgatherv", x, {}),
                           ("allgatherv", x, {"sizes": {"b": [1]}}),
                           ("broadcast", {"a": None}, {})):
        r, t = _texts(lambda: ref.plan(kind, spec, **kw),
                      lambda: comm.plan(kind, _to_torch(spec), **kw))
        assert r == t, kind
    with pytest.raises(ValueError, match="unsupported reduction op"):
        comm.plan("reduce", _to_torch(x), op="min")

    # the resolvers' shape checks, at p = 2 on specs of the wrong shape
    md = rcomm.DEFAULT_MODEL
    for a, kw in ((np.zeros((3, 4), np.float32), {}),
                  (np.zeros((2, 5), np.float32), {})):
        ts, rs = payload_spec(_to_torch({"a": a})), rcomm.payload_spec({"a": a})
        for rfn, tfn, args in (
                (rcomm._resolve_broadcast, tcomm._resolve_broadcast,
                 ((rs, 2, None, md, rcomm.optimal_num_blocks_bcast),
                  (ts, 2, None, DEFAULT_MODEL, optimal_num_blocks_bcast))),
                (rcomm._resolve_allgather, tcomm._resolve_allgather,
                 ((rs, 2, None, md), (ts, 2, None, DEFAULT_MODEL))),
                (rcomm._resolve_reduce_scatter, tcomm._resolve_reduce_scatter,
                 ((rs, 2, None, md), (ts, 2, None, DEFAULT_MODEL))),
                (rcomm._resolve_allgatherv, tcomm._resolve_allgatherv,
                 ((rs, 2, None, md, ((3, 9),)), (ts, 2, None, DEFAULT_MODEL, ((3, 9),)))),
                (rcomm._resolve_allgatherv, tcomm._resolve_allgatherv,
                 ((rs, 2, None, md, ((3,),)), (ts, 2, None, DEFAULT_MODEL, ((3,),))))):
            try:
                want = ("ok", rfn(*args[0]))
            except ValueError as e:
                want = ("raises", str(e))
            try:
                got = ("ok", tfn(*args[1]))
            except ValueError as e:
                got = ("raises", str(e))
            assert got == want, (rfn.__name__, a.shape)


def test_block_count_resolution_matches_the_reference_at_1152():
    from repro.core import comm as rcomm

    from repro_torch.core.comm import payload_spec

    # the chip run's payloads: n = 58 (broadcast), 43 (allgather and
    # reduce_scatter), and allgatherv's clamp to the smallest size
    p = 1152
    cases = [
        ("broadcast", {"w": (p, 3145728), "b": (p, 1048576)}),
        ("reduce", {"w": (p, 3145728), "b": (p, 1048576)}),
        ("allgather", {"a": (p, 2048)}),
        ("reduce_scatter", {"m": (p, p * 2048)}),
    ]
    for kind, shapes in cases:
        tspec = payload_spec({k: torch.empty(s, device="meta", dtype=torch.int32
                                             if k == "b" else torch.float32)
                              for k, s in shapes.items()})
        rspec = rcomm.payload_spec({k: jax.ShapeDtypeStruct(
            s, np.int32 if k == "b" else np.float32) for k, s in shapes.items()})
        if kind in ("broadcast", "reduce"):
            opt = "optimal_num_blocks_" + ("bcast" if kind == "broadcast" else "reduce")
            want = rcomm._resolve_broadcast(rspec, p, None, rcomm.DEFAULT_MODEL,
                                            getattr(rcomm, opt))
            got = tcomm._resolve_broadcast(tspec, p, None, tcomm.DEFAULT_MODEL,
                                           getattr(tcomm, opt))
        else:
            fn = "_resolve_" + kind
            want = getattr(rcomm, fn)(rspec, p, None, rcomm.DEFAULT_MODEL)
            got = getattr(tcomm, fn)(tspec, p, None, tcomm.DEFAULT_MODEL)
        assert got == want, kind
    sizes = tuple(int(s) for s in np.random.default_rng(0).integers(64, 2049, p))
    rspec = rcomm.payload_spec({"v": jax.ShapeDtypeStruct((p, 2048), np.int32)})
    tspec = payload_spec({"v": torch.empty((p, 2048), dtype=torch.int32, device="meta")})
    assert tcomm._resolve_allgatherv(tspec, p, None, tcomm.DEFAULT_MODEL, (sizes,)) \
        == rcomm._resolve_allgatherv(rspec, p, None, rcomm.DEFAULT_MODEL, (sizes,))


def test_plan_cache_identity_and_kind_canonicalization():
    comm = get_comm(StackedGroup(5, device="cpu"), backend="torch")
    assert comm is get_comm(StackedGroup(5, device="cpu"), backend="torch")
    assert comm is not get_comm(StackedGroup(5, device="cpu"), backend="cuda")
    x = {"a": torch.zeros((5, 8))}
    p1 = comm.plan("broadcast", x, n_blocks=2)
    assert p1 is comm.plan("broadcast", x, n_blocks=2)
    assert p1 is comm.plan("broadcast", tcomm.payload_spec(x), n_blocks=2)
    auto = comm.plan("broadcast", x)
    assert comm.plan("broadcast", x, n_blocks=auto.n_blocks) is auto
    g = torch.zeros((10, 3))
    assert comm.plan("allbroadcast", g) is comm.plan("allgather", g)
    assert comm.plan("allbroadcast", g).kind == "allgather"
    sizes = [1, 2, 3, 4, 5]
    v = {"v": torch.zeros((5, 6))}
    assert comm.plan("allgatherv", v, sizes=sizes) is comm.plan(
        "allgatherv", v, sizes={"v": np.asarray(sizes)})
    assert "overlap" in comm.plan("reduce", x, n_blocks=2, overlap=True).describe()


class Pair(namedtuple("Pair", "x y")):
    pass


Point = namedtuple("Point", "u v")


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": 2},
    {"z": [3, {"y": 4, "x": (5, None, 6)}], "a": None, "m": ()},
    [Point(7, [8, 9]), OrderedDict([("q", 10), ("c", 11)])],
    (defaultdict(list, {"k": 12, "e": 13}), {}, [None], 14),
    15,
    None,
], ids=["dict", "nested", "namedtuple_odict", "defaultdict", "leaf", "none"])
def test_leaf_order_and_treedef_text_match_jax(tree):
    leaves, treedef = tree_flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert leaves == jleaves
    assert str(treedef) == str(jdef)
    assert treedef.num_leaves == jdef.num_leaves
    back = tree_unflatten(treedef, leaves)
    assert tree_flatten(back)[1] == treedef
    assert str(jax.tree.structure(back)) == str(jdef)


def test_quantized_allreduce_argument_errors():
    """The quantized kind takes the reference's argument errors: no
    overlapped loop, always a sum, float32 leaves only (its texts)."""
    comm = get_comm(StackedGroup(5, device="cpu"), backend="torch")
    g = {"g": torch.zeros((5, 512))}
    with pytest.raises(ValueError, match="overlap= is not supported for kind "
                                         "'quantized_allreduce'"):
        comm.plan("quantized_allreduce", g, overlap=True)
    with pytest.raises(ValueError, match="quantized_allreduce always sums"):
        comm.plan("quantized_allreduce", g, op="max")
    with pytest.raises(ValueError, match="requires float32 leaves .* got bfloat16"):
        comm.plan("quantized_allreduce", {"g": torch.zeros((5, 512), dtype=torch.bfloat16)})
    assert "quantized_allreduce" in tcomm.KINDS
    sums, errs = comm.plan("quantized_allreduce", g)(g)
    assert not sums["g"].any() and not errs["g"].any()


def test_groups_raise_without_a_card_or_a_process_group(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedGroup(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedGroup(4, device="cuda")
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistGroup()
    with pytest.raises(ValueError, match="p >= 1"):
        StackedGroup(0, device="cpu")


def test_dist_group_takes_gloo_only(monkeypatch):
    """An nccl group is refused (no DistGroup has run on a card); the
    process group is faked, none is started in this process."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="gloo only, not 'nccl'"):
        DistGroup()
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    group = DistGroup()
    assert (group.p, group.rank, group.device) == (4, 0, torch.device("cpu"))


OFF_DEVICE = [("broadcast", {"root": 1}), ("reduce", {"op": "max"}),
              ("allreduce", {}), ("allgather", {}), ("allbroadcast", {}),
              ("allgatherv", {"sizes": [3, 1, 2]}), ("reduce_scatter", {})]


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("kind,kw", OFF_DEVICE, ids=[k for k, _ in OFF_DEVICE])
def test_leaves_off_the_group_device_raise(kind, kw, p):
    """A tensor leaf on another device than the group's is refused,
    naming both devices, before anything runs (the p = 1 identity too):
    no plan copies a leaf to the group's device and back."""
    if kind == "allgatherv":
        kw = {"sizes": kw["sizes"][:p]}
    comm = get_comm(StackedGroup(p, device="cpu"), backend="torch")
    good = {"a": torch.zeros((p, 6)), "b": torch.zeros((p, 3), dtype=torch.int32)}
    bad = {"a": torch.zeros((p, 6), device="meta"), "b": good["b"]}
    plan = comm.plan(kind, good, **kw)
    assert plan(good) is not None
    with pytest.raises(ValueError, match="leaf 0 is on meta, the group's "
                                         "ranks are on cpu"):
        plan(bad)
    if plan.kind in ("allgather", "allgatherv"):
        with pytest.raises(ValueError, match="leaf 0 is on meta"):
            plan.per_rank(bad)
    else:
        with pytest.raises(ValueError, match="per_rank applies to allgather"):
            plan.per_rank(good)


def test_ring_allgather_refuses_a_leaf_off_the_group_device():
    with pytest.raises(ValueError, match="leaf 0 is on meta"):
        tcoll.ring_allgather(StackedGroup(3, device="cpu"),
                             torch.zeros((3, 4), device="meta"))


def test_restore_plan_matches_the_reference():
    from repro.train.restore_broadcast import restore_plan as ref_restore_plan

    for p, nbytes, root in ((2, 1 << 20, 0), (8, 123456, 3), (1152, 16 << 20, 100)):
        rb, rn, rr = ref_restore_plan(p, nbytes, root=root)
        tb, tn, tr = restore_plan(p, nbytes, root=root)
        assert (tn, tr, tb.p, tb.root) == (rn, rr, rb.p, rb.root)


def test_shims_share_the_plan_cache():
    group = StackedGroup(5, device="cpu")
    x = torch.arange(5 * 7, dtype=torch.float32).view(5, 7)
    a = tcoll.circulant_broadcast(group, x, n_blocks=3, root=2, backend="torch")
    b = get_comm(group, backend="torch").broadcast(x, n_blocks=3, root=2)
    assert torch.equal(a, b) and torch.equal(a, x[2].expand(5, 7))
    for name in tcoll.__all__:
        assert hasattr(tcoll, name)
