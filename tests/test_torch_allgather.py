"""The port's allgather (all-to-all broadcast), on the CPU, against the
JAX package.

References from ``repro``:

  * a replay of ``HostDataPlan._run_allgather`` (repro/core/comm.py),
    sequential and overlapped, built from the package's own pieces --
    ``broadcast_slot_plan``, Condition 2's base rotation of the receive
    table, the round steps (Pallas in interpret mode for p <= 11, where
    the grid has p*p rows; the ``"jnp"`` step above that) and
    ``jnp.roll`` -- under a scoped ``jax.enable_x64(True)``;
  * the message-passing simulators ``repro.core.simulate_allgather`` and
    ``simulate_allbroadcast`` with ``backend=None``;
  * the package's ``allgather_phase_static``.

Tolerance: exact, bit for bit (the allgather only moves data).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import simulate_allbroadcast as ref_simulate_allbroadcast
from repro.core import simulate_allgather as ref_simulate_allgather
from repro.core import roundstep as ref_rs
from repro.core.engine import get_bundle as ref_get_bundle
from repro_torch.core import (
    host_plan,
    simulate_allbroadcast,
    simulate_allgather,
)
from repro_torch.core.roundstep import CudaRoundStep

PS = [1, 2, 3, 5, 11, 17, 36]
NS = [1, 4, 7]
DTYPES = ["int32", "float32", "float64", "int64", "bfloat16"]
CASES = [(p, n, DTYPES[i % len(DTYPES)])
         for i, (p, n) in enumerate((p, n) for p in PS for n in NS)]
BS = 2
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


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


def _ref_rows(p, n):
    """The reference's per-round row-slot vectors, ``slots(t, shift)`` of
    ``_run_allgather``: recv_slots[t][(base + shift) % p] flattened."""
    recv_slots, _, ks = ref_rs.broadcast_slot_plan(ref_get_bundle(p, 0), n)
    base = (np.arange(p)[:, None] - np.arange(p)[None, :]) % p
    return lambda t, shift: recv_slots[t][(base + shift) % p].reshape(-1), ks


def _replay(p, n, vals, overlap):
    """repro/core/comm.py HostDataPlan._run_allgather, step for step."""
    bs = vals.shape[-1]
    buf = np.zeros((p, p, n + 1, bs), vals.dtype)
    for j in range(p):
        buf[j, j, :n] = vals[j]
    if p == 1:
        return buf[:, :, :n]
    rows, ks = _ref_rows(p, n)
    bundle = ref_get_bundle(p, 0)
    skips = [int(bundle.skip[int(k)]) for k in ks]
    step = (ref_rs.get_round_step("pallas", interpret=True) if p <= 11
            else ref_rs.get_round_step("jnp"))

    def slots(t, shift):
        return jnp.asarray(rows(t, shift))

    R = len(ks)
    with jax.enable_x64(True):
        buf = jnp.asarray(buf.reshape(p * p, n + 1, bs))
        msg = step.pack(buf, slots(0, skips[0]))
        for t in range(R):
            got = jnp.roll(msg.reshape(p, p, bs), skips[t], axis=0).reshape(p * p, bs)
            if t + 1 < R:
                nxt = slots(t + 1, skips[t + 1])
                if overlap:
                    pre = step.pack(buf, nxt)
                    buf, msg = step.shuffle_staged(buf, got, pre, slots(t, 0), nxt)
                else:
                    buf, msg = step.shuffle(buf, got, slots(t, 0), nxt)
            else:
                buf = step.unpack(buf, got, slots(t, 0))
        return np.asarray(buf).reshape(p, p, n + 1, bs)[:, :, :n]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("p,n,dtype", CASES)
def test_allgather_matches_replay_of_reference(p, n, dtype, overlap):
    vals = _values(p, n, dtype, seed=p * 10 + n)
    want = _torch(_replay(p, n, vals, overlap))
    got = host_plan("allgather", p, n, backend="torch", overlap=overlap,
                    device="cpu").run(_torch(vals))
    assert _same_bits(got, want)
    assert _same_bits(got, _torch(vals).expand(p, p, n, BS))


@pytest.mark.parametrize("p", PS)
def test_simulate_allgather_and_allbroadcast_certify_backend(p):
    for n in NS:
        for mine, theirs in (
                (simulate_allgather(p, n, backend="torch", device="cpu"),
                 ref_simulate_allgather(p, n)),
                (simulate_allbroadcast(p, n, backend="torch", device="cpu"),
                 ref_simulate_allbroadcast(p, n))):
            assert (mine.rounds, mine.optimal_rounds, mine.messages,
                    mine.blocks_moved) == (theirs.rounds, theirs.optimal_rounds,
                                           theirs.messages, theirs.blocks_moved)
            assert mine.backend == "torch"


@pytest.mark.parametrize("p", [2, 5, 11, 36])
def test_allgather_row_tables_match_reference(p):
    n = 4
    plan = host_plan("allgather", p, n, root=3, backend="cuda", device="cpu")
    assert plan is host_plan("allgather", p, n, backend="cuda", device="cpu")
    assert isinstance(plan.step, CudaRoundStep) and plan.root == 0
    rows, ks = _ref_rows(p, n)
    recv_rows, send_rows = plan.device_slots
    assert recv_rows.dtype == send_rows.dtype == torch.int32
    assert tuple(recv_rows.shape) == tuple(send_rows.shape) == (len(ks), p * p)
    for t in range(len(ks)):
        assert np.array_equal(recv_rows[t].numpy(), rows(t, 0))
        assert np.array_equal(send_rows[t].numpy(), rows(t, plan.skips[t]))
    (static,) = plan.statics
    want = ref_rs.allgather_phase_static(ref_get_bundle(p, 0), n)
    assert static.kind == "allgather" and static.slots[0] is plan.slots[0]
    assert np.array_equal(static.slots[0], want.slots[0])
    assert static.shifts == want.shifts == plan.skips


def test_allgather_values_shape_is_checked():
    plan = host_plan("allgather", 5, 3, backend="torch", device="cpu")
    assert tuple(plan.run(np.zeros((5, 3), np.int64)).shape) == (5, 5, 3, 1)
    with pytest.raises(ValueError):
        plan.run(np.zeros((5, 4, 2), np.int64))
