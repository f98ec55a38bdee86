"""The port's two-level hierarchical host plans, on the CPU, against the
JAX package.

References from ``repro``:

  * the reference's own composition code -- ``repro.core.hier``'s
    ``HierHostPlan`` and ``_AllreduceHostPlan`` with their sweeps --
    built over stand-in level plans whose ``run`` replays the
    reference's flat ``HostDataPlan._run_broadcast`` / ``_run_reduce`` /
    ``_run_allgather`` (repro/core/comm.py) from the package's pieces:
    the slot plans, the ``"jnp"`` round step and ``jnp.roll``, under a
    scoped ``jax.enable_x64(True)`` (the reference's own ``run`` cannot
    serve: its ``_x64()`` imports ``jax.experimental.enable_x64``, which
    JAX 0.9 no longer has);
  * the message-passing simulators ``repro.core.simulate_hier_broadcast``,
    ``simulate_hier_reduce`` and ``simulate_hier_allreduce`` with
    ``backend=None`` and their buffers;
  * ``repro.core.hier.hier_rounds`` and the statics of the reference's
    ``hier_host_plan`` (building it does not reach ``_x64()``).

Tolerance: exact, bit for bit.  Float contributions are standard normal,
so every partial sum is a normal number (the port keeps IEEE denormals
where XLA on the CPU flushes them; that difference is pinned in
``test_torch_kernels.py``).  The reference's sweeps check the copies a
level leaves on its ranks with ``np.array_equal``, which calls a NaN
payload diverged; the port compares bits.  So payloads with NaN are
held against the reference composition where it has no such check (the
reduce sweep) and against the exact result elsewhere, and the
difference is pinned by its own test.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hier as ref_hier
from repro.core import roundstep as ref_rs
from repro.core import simulate_hier_allreduce as ref_simulate_hier_allreduce
from repro.core import simulate_hier_broadcast as ref_simulate_hier_broadcast
from repro.core import simulate_hier_reduce as ref_simulate_hier_reduce
from repro.core.engine import get_bundle as ref_get_bundle
from repro.kernels import reduce_ops as ref_ops
from repro_torch.core import (
    HIER_KINDS,
    hier_host_plan,
    hier_rounds,
    simulate_hier_allreduce,
    simulate_hier_broadcast,
    simulate_hier_reduce,
)
from repro_torch.core import hier
from repro_torch.core.roundstep import CudaRoundStep, TorchRoundStep

GRIDS = [(1, 1), (1, 5), (5, 1), (2, 3), (3, 4), (4, 8), (36, 32)]
KINDS = ["broadcast", "reduce", "allreduce", "allgather"]
#: (n_inter, n_intra, m, root, dtype, op): n = 1 at both levels; block
#: counts that leave a padded tail at both levels (m = 7, 13); counts
#: that divide m; and max over +-0 and NaN ("specials", float32).
SPECS = [(1, 1, 5, "first", "int32", "sum"),
         (2, 3, 7, "last", "float32", "sum"),
         (3, 2, 12, "mid", "int64", "+"),
         (4, 5, 13, "last", "specials", "max")]
_BITS = {4: torch.int32, 8: torch.int64}


def _root(where, p):
    return {"first": 0, "mid": p // 2, "last": p - 1}[where]


def _values(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "specials":
        v = rng.standard_normal(shape).astype(np.float32)
        flat = v.reshape(-1)
        flat[2::5], flat[3::5] = -0.0, 0.0
        flat[0::97] = np.nan
        return v
    if dtype.startswith("int"):
        return rng.integers(-1000, 1000, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _torch(a):
    return torch.from_numpy(np.array(a))


def _same_bits(a, b):
    bits = _BITS[a.element_size()]
    return a.shape == b.shape and torch.equal(a.contiguous().view(bits),
                                              b.contiguous().view(bits))


# ------------------------------------------- the reference's composition


class _RefLevel:
    """One flat level plan of the reference, its ``run`` replayed from the
    package's pieces as repro/core/comm.py's ``HostDataPlan`` runs it."""

    def __init__(self, kind, p, n, root=0, op=None):
        self.kind, self.p, self.n, self.root, self.op = kind, p, n, root, op
        bundle = ref_get_bundle(p, root)
        if kind == "reduce":
            self.slots = ref_rs.reduce_slot_plan(bundle, n)
        else:
            self.slots = ref_rs.broadcast_slot_plan(bundle, n)
        self.skips = [int(bundle.skip[int(k)]) for k in self.slots[-1]]
        self.step = ref_rs.get_round_step("jnp")

    def run(self, values):
        with jax.enable_x64(True):
            return getattr(self, "_" + self.kind)(np.asarray(values))

    def _broadcast(self, vals):                       # [n, bs]
        p, n, step = self.p, self.n, self.step
        recv, send, _ = self.slots
        buf = np.zeros((p, n + 1, vals.shape[-1]), vals.dtype)
        buf[self.root, :n] = vals
        buf = jnp.asarray(buf)
        msg = step.pack(buf, jnp.asarray(send[0]))
        R = len(self.skips)
        for t in range(R):
            got = jnp.roll(msg, self.skips[t], axis=0)
            if t + 1 < R:
                buf, msg = step.shuffle(buf, got, jnp.asarray(recv[t]),
                                        jnp.asarray(send[t + 1]))
            else:
                buf = step.unpack(buf, got, jnp.asarray(recv[t]))
        return np.asarray(buf)[:, :n]

    def _reduce(self, vals):                          # [p, n, bs]
        p, n, step, op = self.p, self.n, self.step, self.op
        fwd, acc, _ = self.slots
        bs = vals.shape[-1]
        ident = ref_ops.op_identity(op, vals.dtype)
        buf = jnp.asarray(np.concatenate(
            [vals, np.zeros((p, 1, bs), vals.dtype),
             np.full((p, 1, bs), ident, vals.dtype)], axis=1))
        garbage = jnp.full((p,), n, jnp.int32)
        buf, msg = step.acc_shuffle(buf, jnp.zeros((p, bs), buf.dtype), garbage,
                                    jnp.asarray(fwd[0]), op=op)
        R = len(self.skips)
        for t in range(R):
            got = jnp.roll(msg, -self.skips[t], axis=0)
            nxt = jnp.asarray(fwd[t + 1]) if t + 1 < R else garbage
            buf, msg = step.acc_shuffle(buf, got, jnp.asarray(acc[t]), nxt,
                                        op=op)
        return np.asarray(buf)[:, :n]

    def _allgather(self, vals):                       # [p, n, bs]
        p, n, step = self.p, self.n, self.step
        recv = self.slots[0]
        bs = vals.shape[-1]
        buf = np.zeros((p, p, n + 1, bs), vals.dtype)
        for j in range(p):
            buf[j, j, :n] = vals[j]
        base = (np.arange(p)[:, None] - np.arange(p)[None, :]) % p

        def slots(t, shift):
            return jnp.asarray(recv[t][(base + shift) % p].reshape(-1))

        buf = jnp.asarray(buf.reshape(p * p, n + 1, bs))
        msg = step.pack(buf, slots(0, self.skips[0]))
        R = len(self.skips)
        for t in range(R):
            got = jnp.roll(msg.reshape(p, p, bs), self.skips[t],
                           axis=0).reshape(p * p, bs)
            if t + 1 < R:
                buf, msg = step.shuffle(buf, got, slots(t, 0),
                                        slots(t + 1, self.skips[t + 1]))
            else:
                buf = step.unpack(buf, got, slots(t, 0))
        return np.asarray(buf).reshape(p, p, n + 1, bs)[:, :, :n]


def _ref_plan(kind, nodes, cores, nN, nC, root=0, op=None):
    """repro.core.hier's HierHostPlan / _AllreduceHostPlan over _RefLevel
    stand-ins, levels chosen as the reference's hier_host_plan does."""
    rootN, rootC = divmod(root, cores)
    op = op if kind in ("reduce", "allreduce") else None
    common = dict(kind=kind, nodes=nodes, cores=cores, n_inter=nN,
                  n_intra=nC, root=root, op=op, backend="jnp")
    if kind == "allreduce":
        return ref_hier._AllreduceHostPlan(
            inter=((_RefLevel("reduce", nodes, nN, rootN, op),
                    _RefLevel("broadcast", nodes, nN, rootN))
                   if nodes > 1 else None),
            intra=((_RefLevel("reduce", cores, nC, rootC, op),
                    _RefLevel("broadcast", cores, nC, rootC))
                   if cores > 1 else None),
            **common)
    return ref_hier.HierHostPlan(
        inter=_RefLevel(kind, nodes, nN, rootN, op) if nodes > 1 else None,
        intra=_RefLevel(kind, cores, nC, rootC, op) if cores > 1 else None,
        **common)


# ------------------------------------------------------------ round counts


@pytest.mark.parametrize("kind", HIER_KINDS)
def test_hier_rounds_match_reference(kind):
    for nodes, cores in GRIDS:
        for nN, nC in [(1, 1), (2, 3), (41, 37)]:
            assert hier_rounds(kind, nodes, cores, nN, nC) == \
                ref_hier.hier_rounds(kind, nodes, cores, nN, nC)
    assert hier_rounds("allbroadcast", 6, 4, 2, 2) == \
        hier_rounds("allgather", 6, 4, 2, 2)


def test_hier_rounds_rejects_an_unknown_kind_as_the_reference():
    with pytest.raises(ValueError) as mine:
        hier_rounds("gossip", 2, 2, 1, 1)
    with pytest.raises(ValueError) as theirs:
        ref_hier.hier_rounds("gossip", 2, 2, 1, 1)
    assert str(mine.value) == str(theirs.value)
    assert HIER_KINDS == ref_hier.HIER_KINDS


# ----------------------------------------------------- the host data plans


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"n{s[0]}x{s[1]}-m{s[2]}-{s[4]}-{s[5]}")
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_hier_plan_matches_reference_composition(kind, grid, spec):
    nodes, cores = grid
    nN, nC, m, where, dtype, op = spec
    p = nodes * cores
    root = _root(where, p) if kind != "allgather" else 0
    seed = 1000 * nodes + 10 * cores + m
    vals = _values((m,) if kind == "broadcast" else (nodes, cores, m), dtype,
                   seed)
    got = hier_host_plan(kind, nodes, cores, nN, nC, root=root, op=op,
                         backend="torch", device="cpu").run(_torch(vals))
    assert got.device.type == "cpu" and got.dtype == _torch(vals).dtype
    if kind == "broadcast":
        exact = np.broadcast_to(vals, (nodes, cores, m))
    elif kind == "allgather":
        exact = vals.reshape(p, m)
    else:
        exact = None
    if dtype != "specials" or kind == "reduce":
        want = _ref_plan(kind, nodes, cores, nN, nC, root, op).run(vals)
    elif kind == "allreduce":
        # the reference's broadcast sweep calls a NaN payload diverged:
        # the reduce composition, held at every rank
        red = _ref_plan("reduce", nodes, cores, nN, nC, root, op).run(vals)
        want = np.broadcast_to(red, (nodes, cores, m))
    else:
        want = exact
    assert _same_bits(got, _torch(want))
    if exact is not None:
        assert _same_bits(got, _torch(exact))
    if dtype.startswith("int") and kind in ("reduce", "allreduce"):
        total = vals.reshape(p, m).sum(0, dtype=vals.dtype)
        if kind == "reduce":
            assert np.array_equal(got.numpy(), total)
        if kind == "allreduce":
            assert np.array_equal(got.numpy(),
                                  np.broadcast_to(total, (nodes, cores, m)))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("kind", ["broadcast", "reduce", "allreduce"])
def test_hier_plan_matches_reference_simulator_buffers(kind, grid):
    nodes, cores = grid
    p = nodes * cores
    for i, (nN, nC) in enumerate([(1, 1), (2, 3), (3, 2)]):
        root = [p - 1, p // 2, 0][i]
        m = 2 * nN * nC
        plan = hier_host_plan(kind, nodes, cores, nN, nC, root=root,
                              op="+", backend="torch", device="cpu")
        if kind == "broadcast":
            atoms = list(_values((m,), "int64", seed=p + i))
            res = ref_simulate_hier_broadcast(nodes, cores, nN, nC, root=root,
                                              keep_buffers=True, payloads=atoms)
            want = np.array(res.buffers)                     # [nodes, cores, m]
            assert np.array_equal(plan.run(np.asarray(atoms)).numpy(), want)
            continue
        dtype = ["int32", "int64", "float64"][i]
        vals = _values((nodes, cores, m), dtype, seed=p + i)
        ref = (ref_simulate_hier_reduce if kind == "reduce"
               else ref_simulate_hier_allreduce)
        res = ref(nodes, cores, nN, nC, root=root, op="+", values=vals,
                  keep_buffers=True)
        got = plan.run(vals)
        want = np.asarray(res.buffers[0]).reshape(-1)
        if kind == "allreduce":
            want = np.broadcast_to(want, (nodes, cores, m))
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("kind", KINDS + ["allbroadcast"])
def test_statics_match_reference(kind, grid):
    nodes, cores = grid
    p = nodes * cores
    nN, nC, root = 3, 2, p - 1
    mine = hier_host_plan(kind, nodes, cores, nN, nC, root=root, op="max",
                          backend="torch", device="cpu").statics
    theirs = ref_hier.hier_host_plan(kind, nodes, cores, nN, nC, root=root,
                                     op="max").statics
    assert len(mine) == len(theirs)
    if p == 1:
        assert mine == ()
    if nodes == 1 or cores == 1:
        per_level = {"allreduce": 2}.get(kind, 1)
        assert len(mine) == per_level * (p > 1)
    for a, b in zip(mine, theirs):
        for f in ("kind", "direction", "p", "root", "n", "nslots", "shifts",
                  "axis", "overlap"):
            assert getattr(a, f) == getattr(b, f), f
        assert np.array_equal(a.ks, b.ks)
        assert len(a.slots) == len(b.slots)
        for x, y in zip(a.slots, b.slots):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_allreduce_statics_run_order():
    plan = hier_host_plan("allreduce", 3, 4, 2, 3, root=5, backend="torch",
                          device="cpu")
    red_n, bc_n = plan.inter
    red_c, bc_c = plan.intra
    want = red_c.statics + red_n.statics + bc_n.statics + bc_c.statics
    assert len(plan.statics) == len(want) == 4
    # built from the same process-cached slot plans the levels run
    assert all(a.slots[0] is b.slots[0] and a.slots[0] is plan_.slots[0]
               for a, b, plan_ in zip(plan.statics, want,
                                      (red_c, red_n, bc_n, bc_c)))
    assert [(s.kind, s.p) for s in plan.statics] == [
        ("reduce", 4), ("reduce", 3), ("broadcast", 3), ("broadcast", 4)]


# ------------------------------------------------------ the port's simulators


@pytest.mark.parametrize("grid", GRIDS[:6], ids=lambda g: f"{g[0]}x{g[1]}")
def test_simulate_hier_certification_grid(grid):
    """The reference's certification grid (tests/test_hier.py), each run
    certifying the port's data plane and counting as the reference's
    message-passing run does."""
    nodes, cores = grid
    for nN, nC in [(1, 2), (2, 3)]:
        root = (nodes * cores) // 2
        for mine_fn, ref_fn in ((simulate_hier_broadcast,
                                 ref_simulate_hier_broadcast),
                                (simulate_hier_reduce, ref_simulate_hier_reduce)):
            mine = mine_fn(nodes, cores, nN, nC, root=root, backend="torch",
                           device="cpu")
            theirs = ref_fn(nodes, cores, nN, nC, root=root)
            assert (mine.rounds, mine.optimal_rounds, mine.rounds_inter,
                    mine.rounds_intra, mine.messages, mine.blocks_moved) == (
                theirs.rounds, theirs.optimal_rounds, theirs.rounds_inter,
                theirs.rounds_intra, theirs.messages, theirs.blocks_moved)
            assert mine.backend == "torch"
    mine = simulate_hier_allreduce(nodes, cores, 2, 2, backend="torch",
                                   device="cpu")
    theirs = ref_simulate_hier_allreduce(nodes, cores, 2, 2)
    assert (mine.rounds, mine.messages) == (theirs.rounds, theirs.messages)
    assert np.array_equal(np.asarray(mine.buffers[0]),
                          np.asarray(theirs.buffers[0]))


def test_simulate_hier_max_and_float_sums():
    simulate_hier_reduce(3, 4, 2, 2, op="max", backend="torch", device="cpu")
    simulate_hier_allreduce(2, 4, 1, 2, op="max", backend="torch", device="cpu")
    vals = np.random.default_rng(3).normal(size=(3, 4, 12))
    r = simulate_hier_reduce(3, 4, 2, 3, values=vals, backend="torch",
                             device="cpu")
    theirs = ref_simulate_hier_reduce(3, 4, 2, 3, values=vals)
    assert np.array_equal(r.buffers[0], theirs.buffers[0])
    with pytest.raises(AssertionError, match="divide"):
        simulate_hier_reduce(2, 2, 2, 3, values=np.zeros((2, 2, 7)))


def test_simulate_hier_36x32_paper_topology():
    """The reference test's arguments (tests/test_hier.py) on the port's
    simulators, certifying its data plane at 1152 ranks."""
    r = simulate_hier_broadcast(36, 32, 3, 2, root=35 * 32 + 7,
                                backend="torch", device="cpu")
    theirs = ref_simulate_hier_broadcast(36, 32, 3, 2, root=35 * 32 + 7)
    assert (r.rounds, r.rounds_inter, r.rounds_intra, r.messages) == (
        theirs.rounds, theirs.rounds_inter, theirs.rounds_intra,
        theirs.messages) == (r.optimal_rounds, 8, 6, theirs.messages)
    r = simulate_hier_reduce(36, 32, 2, 2, root=100, backend="torch",
                             device="cpu")
    assert r.rounds == r.optimal_rounds
    assert np.array_equal(r.buffers[0], ref_simulate_hier_reduce(
        36, 32, 2, 2, root=100).buffers[0])
    r = simulate_hier_allreduce(36, 32, 2, 1, backend="torch", device="cpu")
    assert r.rounds == r.optimal_rounds == 2 * (7 + 5)


# -------------------------------------------------------------- the seams


@pytest.mark.parametrize("m,n", [(12, 3), (12, 5), (7, 7), (5, 8), (1, 1)])
def test_split_matches_the_reference_and_views_where_n_divides_m(m, n):
    flat = torch.arange(1, m + 1, dtype=torch.int64)
    got = hier._split(flat, n)
    assert np.array_equal(got.numpy(), ref_hier._split_np(flat.numpy(), n))
    assert (got.data_ptr() == flat.data_ptr()) == (m % n == 0)
    rows = torch.stack([flat, -flat])
    assert np.array_equal(hier._split(rows, n)[1].numpy(),
                          ref_hier._split_np(-flat.numpy(), n))


class _ReusingPlan:
    """A flat plan that returns one buffer it reuses on every call."""

    def __init__(self, plan):
        self.plan, self.buf = plan, None

    def run(self, values):
        out = self.plan.run(values)
        if self.buf is None:
            self.buf = torch.empty_like(out)
        self.buf.copy_(out)
        return self.buf


def test_node_partials_do_not_alias_across_the_node_loop():
    # Every node's partial differs; a plan that reuses its buffer must not
    # turn them all into the last node's.
    nodes, cores, nN, nC, root = 5, 4, 2, 3, 13
    vals = _values((nodes, cores, 10), "int64", seed=7)
    want = _ref_plan("reduce", nodes, cores, nN, nC, root, "sum").run(vals)
    plan = hier_host_plan("reduce", nodes, cores, nN, nC, root=root,
                          backend="torch", device="cpu")
    got = hier._reduce_sweep(_torch(vals), nodes, cores, nN, nC,
                             _ReusingPlan(plan.intra), plan.inter,
                             plan.root_node, plan.root_core)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), vals.reshape(-1, 10).sum(0))
    ag = hier_host_plan("allgather", nodes, cores, nN, nC, backend="torch",
                        device="cpu")
    reusing = replace(ag, intra=_ReusingPlan(ag.intra))
    assert np.array_equal(reusing.run(vals).numpy(), vals.reshape(-1, 10))


class _Corrupting:
    """A flat plan whose result has the given rows changed after the
    first ``keep`` elements of each row's run of blocks (a port plan's
    tensor or a reference stand-in's array)."""

    def __init__(self, plan, rows, keep=0):
        self.plan, self.rows, self.keep = plan, rows, keep

    def run(self, values):
        out = self.plan.run(values)
        out = out.clone() if isinstance(out, torch.Tensor) else np.array(out)
        for r in self.rows:
            out[r].reshape(-1)[self.keep:] += 1
        return out


@pytest.mark.parametrize("rows,where", [((2, 4), 2), ((4,), 4)])
def test_a_diverged_leader_raises_the_reference_text(rows, where):
    nodes, cores = 5, 3
    vals = np.arange(12, dtype=np.int64)
    plan = hier_host_plan("broadcast", nodes, cores, 2, 2, root=4,
                          backend="torch", device="cpu")
    ref_plan = _ref_plan("broadcast", nodes, cores, 2, 2, root=4)
    with pytest.raises(AssertionError) as a:
        replace(plan, inter=_Corrupting(plan.inter, rows)).run(vals)
    with pytest.raises(AssertionError) as b:
        replace(ref_plan, inter=_Corrupting(ref_plan.inter, rows)).run(vals)
    assert str(a.value) == str(b.value) == (
        f"hier broadcast sweep: node leader {where} diverged")


def test_a_diverged_allgather_rank_raises_the_reference_text():
    nodes, cores, nN, nC = 3, 4, 2, 2
    vals = _values((nodes, cores, 6), "int64", seed=5)
    plan = hier_host_plan("allgather", nodes, cores, nN, nC, backend="torch",
                          device="cpu")
    ref_plan = _ref_plan("allgather", nodes, cores, nN, nC)
    for level, rows, text in (("intra", (3, 2), "node 0 rank 2 diverged"),
                              ("inter", (2,), "inter rank 2 diverged")):
        with pytest.raises(AssertionError) as a:
            replace(plan, **{level: _Corrupting(getattr(plan, level), rows)}
                    ).run(vals)
        with pytest.raises(AssertionError) as b:
            replace(ref_plan, **{level: _Corrupting(getattr(ref_plan, level),
                                                    rows)}).run(vals)
        assert str(a.value) == str(b.value) == f"hier allgather: {text}"


def test_the_padding_is_not_compared():
    # 7 elements in 2 blocks of 4: a change in the padded eighth element
    # of a leader's copy is no divergence, here or in the reference.
    vals = np.arange(1, 8, dtype=np.int64)
    want = np.broadcast_to(vals, (3, 2, 7))
    plan = hier_host_plan("broadcast", 3, 2, 2, 1, root=0, backend="torch",
                          device="cpu")
    got = replace(plan, inter=_Corrupting(plan.inter, (1, 2), keep=7)).run(vals)
    assert np.array_equal(got.numpy(), want)
    ref_plan = _ref_plan("broadcast", 3, 2, 2, 1, root=0)
    assert np.array_equal(replace(ref_plan, inter=_Corrupting(
        ref_plan.inter, (1, 2), keep=7)).run(vals), want)


def test_nan_payloads_agree_by_their_bits():
    # The port compares the leaders' copies by bits; the reference's
    # np.array_equal calls a NaN payload diverged (a deliberate difference).
    vals = np.array([1.0, np.nan, -0.0, 2.0, np.nan, 3.0], np.float32)
    got = hier_host_plan("broadcast", 4, 3, 2, 3, root=5, backend="torch",
                         device="cpu").run(vals)
    assert _same_bits(got, _torch(np.broadcast_to(vals, (4, 3, 6))))
    with pytest.raises(AssertionError, match="node leader 0 diverged"):
        _ref_plan("broadcast", 4, 3, 2, 3, root=5).run(vals)


# --------------------------------------------------------- plan and cache


def test_plans_are_cached_and_compose_the_flat_plans():
    a = hier_host_plan("reduce", 4, 8, 3, 2, root=9, op="max", backend="cuda",
                       device="cpu")
    assert hier_host_plan("reduce", 4, 8, 3, 2, root=9, op="max",
                          backend="cuda", device="cpu") is a
    assert hier_host_plan("reduce", 4, 8, 3, 2, root=9, op="sum",
                          backend="cuda", device="cpu") is not a
    assert (a.root_node, a.root_core) == (1, 1)
    assert isinstance(a.inter.step, CudaRoundStep)
    assert (a.inter.p, a.inter.n, a.inter.root, a.inter.op) == (4, 3, 1, "max")
    assert (a.intra.p, a.intra.n, a.intra.root) == (8, 2, 1)
    b = hier_host_plan("allreduce", 4, 8, 3, 2, root=9, backend="torch",
                       device="cpu")
    assert [(x.kind, x.p) for x in b.inter + b.intra] == [
        ("reduce", 4), ("broadcast", 4), ("reduce", 8), ("broadcast", 8)]
    assert isinstance(b.inter[0].step, TorchRoundStep)
    one = hier_host_plan("broadcast", 1, 6, 1, 2, root=3, device="cpu")
    assert one.inter is None and one.intra.p == 6
    assert hier_host_plan("allgather", 1, 1, 1, 1, device="cpu").inter is None


def test_allbroadcast_is_the_allgather_and_ignores_root():
    plan = hier_host_plan("allgather", 3, 4, 2, 2, backend="torch", device="cpu")
    assert hier_host_plan("allbroadcast", 3, 4, 2, 2, root=7, backend="torch",
                          device="cpu") is plan
    assert plan.kind == "allgather" and plan.root == 0 and plan.op is None


@pytest.mark.parametrize("args,kw,match", [
    (("gossip", 2, 2, 1, 1), {}, "kind"),
    (("broadcast", 2, 2, 1, 1), {"root": 4}, "root"),
    (("reduce", 2, 2, 1, 1), {"root": -1}, "root"),
    (("allreduce", 3, 2, 1, 1), {"root": 6}, "root"),
    (("reduce", 2, 2, 1, 1), {"op": "prod"}, "op"),
    (("broadcast", 2, 2, 1, 1), {"backend": "jnp"}, "backend"),
])
def test_bad_arguments_raise(args, kw, match):
    with pytest.raises(ValueError, match=match):
        hier_host_plan(*args, device="cpu", **kw)
    if match in ("kind", "root"):
        with pytest.raises(ValueError, match=match):
            ref_hier.hier_host_plan(*args, **kw)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in HIER_KINDS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hier_host_plan(kind, 3, 4, 2, 2)
    for simulate in (simulate_hier_broadcast, simulate_hier_reduce,
                     simulate_hier_allreduce):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulate(3, 4, 2, 2, backend="cuda")
