"""The port's reduction and allreduce, on the CPU, against the JAX package.

References from ``repro``:

  * a replay of ``HostDataPlan._run_reduce`` (repro/core/comm.py), both
    its sequential and its overlapped round loop, built from the
    package's own pieces -- ``reduce_slot_plan``, the round steps
    (Pallas in interpret mode for p <= 11, the ``"jnp"`` step above
    that) and ``jnp.roll`` -- under a scoped ``jax.enable_x64(True)``
    (``host_plan(...).run`` itself cannot serve: its ``_x64()`` imports
    ``jax.experimental.enable_x64``, which JAX 0.9 no longer has);
  * the message-passing simulators ``repro.core.simulate_reduce`` and
    ``simulate_allreduce`` with ``backend=None``;
  * the package's slot plans and phase statics, array for array, and its
    op registry (``repro.kernels.reduce_ops``).

Tolerance: exact, bit for bit.  Float contributions are standard normal
(or small integers), so every partial sum is a normal number: XLA on the
CPU flushes denormals to zero where the port keeps IEEE denormals, and
that one deliberate difference is pinned by its own test in
``test_torch_kernels.py``, kept out of every case here.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import simulate_allreduce as ref_simulate_allreduce
from repro.core import simulate_reduce as ref_simulate_reduce
from repro.core import roundstep as ref_rs
from repro.core.engine import get_bundle as ref_get_bundle
from repro.kernels import reduce_ops as ref_ops
from repro_torch.core import (
    get_bundle,
    host_plan,
    simulate_allreduce,
    simulate_reduce,
)
from repro_torch.core import roundstep as rs
from repro_torch.kernels import reduce_ops

PS = [1, 2, 3, 5, 11, 17, 36]
NS = [1, 4, 7]
OPS = ["sum", "+", "max"]
DTYPES = ["int32", "float32", "float64", "int64", "bfloat16"]
BS = 3
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _cases():
    """Each (p, n) once; per p the three n take the three roots and the
    three ops in turn, and the dtypes cycle through the grid."""
    out = []
    for pi, p in enumerate(PS):
        for ni, n in enumerate(NS):
            root = [0, p // 2, p - 1][(ni + pi) % 3]
            op = OPS[(ni + 2 * pi) % 3]
            out.append((p, root, n, op, DTYPES[len(out) % len(DTYPES)]))
    return out


CASES = _cases()


def _values(p, n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        return rng.standard_normal((p, n, BS), dtype=np.float32).astype(ml_dtypes.bfloat16)
    if dtype.startswith("int"):
        return rng.integers(-1000, 1000, size=(p, n, BS)).astype(dtype)
    return rng.standard_normal((p, n, BS)).astype(dtype)


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_bits(a, b):
    bits = _BITS[a.element_size()]
    return a.shape == b.shape and torch.equal(a.contiguous().view(bits),
                                              b.contiguous().view(bits))


def _replay(p, n, root, op, vals, overlap):
    """repro/core/comm.py HostDataPlan._run_reduce, step for step."""
    bs = vals.shape[-1]
    ident = ref_ops.op_identity(op, vals.dtype)
    buf = np.concatenate([vals, np.zeros((p, 1, bs), vals.dtype),
                          np.full((p, 1, bs), ident, vals.dtype)], axis=1)
    if p == 1:
        return buf[:, :n]
    bundle = ref_get_bundle(p, root)
    fwd_slots, acc_slots, ks = ref_rs.reduce_slot_plan(bundle, n)
    skips = [int(bundle.skip[int(k)]) for k in ks]
    step = (ref_rs.get_round_step("pallas", interpret=True) if p <= 11
            else ref_rs.get_round_step("jnp"))
    R = len(ks)
    with jax.enable_x64(True):
        buf = jnp.asarray(buf)
        garbage = jnp.full((p,), n, jnp.int32)
        buf, msg = step.acc_shuffle(buf, jnp.zeros((p, bs), buf.dtype), garbage,
                                    jnp.asarray(fwd_slots[0]), op=op)
        for t in range(R):
            got = jnp.roll(msg, -skips[t], axis=0)
            nxt = jnp.asarray(fwd_slots[t + 1]) if t + 1 < R else garbage
            if overlap:
                pre = step.pack(buf, nxt)
                buf, msg = step.acc_shuffle_staged(
                    buf, got, pre, jnp.asarray(acc_slots[t]), nxt, op=op)
            else:
                buf, msg = step.acc_shuffle(buf, got, jnp.asarray(acc_slots[t]),
                                            nxt, op=op)
        return np.asarray(buf)[:, :n]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("p,root,n,op,dtype", CASES)
def test_reduce_matches_replay_of_reference(p, root, n, op, dtype, overlap):
    vals = _values(p, n, dtype, seed=p * 10 + n)
    want = _torch(_replay(p, n, root, op, vals, overlap))
    got = host_plan("reduce", p, n, root=root, op=op, backend="torch",
                    overlap=overlap, device="cpu").run(_torch(vals))
    assert _same_bits(got, want)
    ident = reduce_ops.op_identity(op, got.dtype)
    if p > 1:   # every non-root rank is drained to the identity
        assert bool((torch.cat([got[:root], got[root + 1:]]) == ident).all())


@pytest.mark.parametrize("op", ["+", "max"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("p", PS)
def test_reduce_matches_reference_simulator(p, n, op):
    # float64 sums pin the accumulation order: the simulator combines in
    # schedule order, as the data plane must.
    root = p // 2
    vals = np.random.default_rng(p + n).standard_normal((p, n))
    res = ref_simulate_reduce(p, n, root, op=op, values=vals)
    want = np.stack([np.asarray(v) for v in res.buffers[root]])
    got = host_plan("reduce", p, n, root=root, op=op, backend="torch",
                    device="cpu").run(vals)
    assert np.array_equal(got[root, :, 0].numpy(), want)


@pytest.mark.parametrize("p", PS)
def test_simulate_reduce_and_allreduce_certify_backend(p):
    for n in NS:
        for root, op in ((0, "max"), (p - 1, "+")):
            for mine, theirs in (
                    (simulate_reduce(p, n, root, op=op, backend="torch",
                                     device="cpu"),
                     ref_simulate_reduce(p, n, root, op=op)),
                    (simulate_allreduce(p, n, root, op=op, backend="torch",
                                        device="cpu"),
                     ref_simulate_allreduce(p, n, root, op=op))):
                assert (mine.rounds, mine.optimal_rounds, mine.messages,
                        mine.blocks_moved) == (theirs.rounds,
                                               theirs.optimal_rounds,
                                               theirs.messages,
                                               theirs.blocks_moved)
                assert mine.backend == "torch"


def test_allreduce_is_reduce_then_broadcast():
    p, n, root = 11, 4, 7
    vals = np.random.default_rng(3).integers(-8, 9, size=(p, n, 5)).astype(np.float32)
    red = host_plan("reduce", p, n, root=root, backend="torch", device="cpu").run(vals)
    out = host_plan("broadcast", p, n, root=root, backend="torch",
                    device="cpu").run(red[root].clone())
    assert torch.equal(out, torch.from_numpy(vals.sum(0)).expand(p, n, 5))


@pytest.mark.parametrize("p", PS)
def test_slot_plans_and_statics_match_reference(p):
    for root in sorted({0, p // 2, p - 1}):
        for n in NS:
            mine, theirs = get_bundle(p, root), ref_get_bundle(p, root)
            if p == 1 and n > 1:
                # The reference's round plan divides by q = 0 here
                # (ROADMAP Queue 1 item 1); the port has no rounds.
                assert all(len(t) == 0 for t in rs.reduce_slot_plan(mine, n))
                continue
            for fn in ("reduce_slot_plan", "scatter_slot_plan"):
                a, b = getattr(rs, fn)(mine, n), getattr(ref_rs, fn)(theirs, n)
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype and np.array_equal(x, y)
                    assert not x.flags.writeable
            for fn in ("reduce_phase_static", "scatter_phase_static",
                       "allgather_phase_static"):
                for overlap in (False, True):
                    a = getattr(rs, fn)(mine, n, overlap=overlap)
                    b = getattr(ref_rs, fn)(theirs, n, overlap=overlap)
                    for f in ("kind", "direction", "p", "root", "n", "nslots",
                              "shifts", "axis", "overlap"):
                        assert getattr(a, f) == getattr(b, f), (fn, f)
                    assert np.array_equal(a.ks, b.ks)
                    assert len(a.slots) == len(b.slots)
                    for x, y in zip(a.slots, b.slots):
                        assert np.array_equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES + ["float16", "int8", "int16"])
@pytest.mark.parametrize("op", OPS)
def test_op_identity_matches_reference(op, dtype):
    want = ref_ops.op_identity(op, getattr(ml_dtypes, dtype, None) or np.dtype(dtype))
    got = reduce_ops.op_identity(op, getattr(torch, dtype))
    assert float(want) == float(got) and np.isinf(float(got)) == np.isinf(float(want))


def test_op_combine_max_matches_xla_on_signed_zero_and_nan():
    a = np.array([np.nan, 1.0, -0.0, 0.0, -0.0, 3.0, 2.0, -np.inf, np.nan], np.float32)
    b = np.array([2.0, np.nan, 0.0, -0.0, -0.0, 3.0, np.nan, -0.0, -np.nan], np.float32)
    for dt in (np.float32, np.float64):
        x, y = a.astype(dt), b.astype(dt)
        with jax.enable_x64(True):
            want = _torch(np.array(jnp.maximum(x, y)))
        got = reduce_ops.op_combine("max")(_torch(x), _torch(y))
        assert _same_bits(got, want)
    ints = np.array([-5, 7, 0, np.iinfo(np.int32).min], np.int32)
    got = reduce_ops.op_combine("max")(_torch(ints), _torch(ints[::-1].copy()))
    assert np.array_equal(got.numpy(), np.maximum(ints, ints[::-1]))


def test_integer_sums_wrap_as_the_reference():
    a = np.array([np.iinfo(np.int32).max, np.iinfo(np.int32).min], np.int32)
    b = np.array([1, -1], np.int32)
    want = np.asarray(jnp.add(a, b))
    assert np.array_equal(reduce_ops.op_combine("sum")(_torch(a), _torch(b)).numpy(), want)


def test_bad_op_raises():
    with pytest.raises(ValueError):
        reduce_ops.op_combine("min")
    with pytest.raises(ValueError):
        host_plan("reduce", 5, 3, op="prod", device="cpu")


def test_reduce_plan_caches_and_uploads_tables_once():
    a = host_plan("reduce", 11, 4, root=3, op="max", backend="cuda", device="cpu")
    assert host_plan("reduce", 11, 4, root=3, op="max", backend="cuda",
                     device="cpu") is a
    assert host_plan("reduce", 11, 4, root=3, op="sum", backend="cuda",
                     device="cpu") is not a
    fwd, acc = a.device_slots
    R = len(a.ks)
    assert fwd.dtype == acc.dtype == torch.int32
    assert np.array_equal(fwd[:R].numpy(), a.slots[0])
    assert bool((fwd[R] == 4).all())             # the last capture: garbage
    assert np.array_equal(acc.numpy(), a.slots[1])
    (static,) = a.statics
    assert static.kind == "reduce" and static.slots[0] is a.slots[0]
    assert static.nslots == 6 and not static.overlap
    assert host_plan("reduce", 11, 4, root=3, op="max", overlap=True,
                     device="cpu").statics[0].overlap


def test_reduce_values_shape_is_checked():
    plan = host_plan("reduce", 5, 3, root=2, backend="torch", device="cpu")
    assert tuple(plan.run(np.zeros((5, 3), np.int64)).shape) == (5, 3, 1)
    assert tuple(plan.run(np.zeros((5, 3, 2, 4), np.float32)).shape) == (5, 3, 8)
    with pytest.raises(ValueError):
        plan.run(np.zeros((4, 3), np.int64))
