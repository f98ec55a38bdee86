"""The port's broadcast as a whole, on the CPU, against the JAX package.

Two references from ``repro``:

  * a replay of ``HostDataPlan._run_broadcast`` (repro/core/comm.py),
    sequential and overlapped, built from the package's own pieces --
    ``broadcast_slot_plan``, the Pallas round steps in interpret mode
    and ``jnp.roll`` -- under a scoped ``jax.enable_x64(True)``.  (``host_plan(...).run`` itself
    cannot serve: its ``_x64()`` imports ``jax.experimental.enable_x64``,
    which JAX 0.9 no longer has.)
  * the message-passing simulator ``repro.core.simulate_broadcast``
    with ``backend=None``.

Tolerance: exact, bit for bit.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import simulate_broadcast as ref_simulate
from repro.core.engine import get_bundle as ref_get_bundle
from repro.core.roundstep import broadcast_slot_plan as ref_slot_plan
from repro.core.roundstep import get_round_step as ref_round_step
from repro_torch.core import host_plan, simulate_broadcast
from repro_torch.core.roundstep import CudaRoundStep, TorchRoundStep

PS = [1, 2, 3, 5, 11, 17, 36]
NS = [1, 4, 7]
DTYPES = ["int32", "float32", "float64", "int64", "bfloat16"]
CASES = [(p, p // 2, n, DTYPES[i % len(DTYPES)])
         for i, (p, n) in enumerate((p, n) for p in PS for n in NS)]
# The sequential cases keep their ids; the overlapped ones add "-overlap".
OVERLAP_CASES = [
    pytest.param(*case, overlap, id="-".join(map(str, case)) + suffix)
    for overlap, suffix in ((False, ""), (True, "-overlap")) for case in CASES]
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _values(n, bs, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        return rng.standard_normal((n, bs), dtype=np.float32).astype(ml_dtypes.bfloat16)
    if dtype.startswith("int"):
        return rng.integers(-1000, 1000, size=(n, bs)).astype(dtype)
    return rng.standard_normal((n, bs)).astype(dtype)


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_bits(a, b):
    bits = _BITS[a.element_size()]
    return a.shape == b.shape and torch.equal(a.contiguous().view(bits),
                                              b.contiguous().view(bits))


def _replay(p, n, root, vals, overlap=False):
    """repro/core/comm.py HostDataPlan._run_broadcast, step for step."""
    buf = np.zeros((p, n + 1, vals.shape[-1]), vals.dtype)
    buf[root, :n] = vals
    if p == 1:
        return buf[:, :n]
    bundle = ref_get_bundle(p, root)
    recv_slots, send_slots, ks = ref_slot_plan(bundle, n)
    skips = [int(bundle.skip[int(k)]) for k in ks]
    step = ref_round_step("pallas", interpret=True)
    R = len(ks)
    with jax.enable_x64(True):
        buf = jnp.asarray(buf)
        msg = step.pack(buf, jnp.asarray(send_slots[0]))
        for t in range(R):
            got = jnp.roll(msg, skips[t], axis=0)
            if t + 1 < R:
                nxt = jnp.asarray(send_slots[t + 1])
                if overlap:
                    pre = step.pack(buf, nxt)
                    buf, msg = step.shuffle_staged(
                        buf, got, pre, jnp.asarray(recv_slots[t]), nxt)
                else:
                    buf, msg = step.shuffle(buf, got,
                                            jnp.asarray(recv_slots[t]), nxt)
            else:
                buf = step.unpack(buf, got, jnp.asarray(recv_slots[t]))
        return np.asarray(buf)[:, :n]


@pytest.mark.parametrize("p,root,n,dtype,overlap", OVERLAP_CASES)
def test_broadcast_matches_replay_of_reference(p, root, n, dtype, overlap):
    vals = _values(n, 5, dtype, seed=p * 10 + n)
    want = _torch(_replay(p, n, root, vals, overlap))
    got = host_plan("broadcast", p, n, root=root, backend="torch",
                    overlap=overlap, device="cpu").run(_torch(vals))
    assert _same_bits(got, want)
    assert _same_bits(got, _torch(vals).expand(p, n, 5))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("p", PS)
def test_broadcast_matches_reference_simulator(p, n):
    root = p - 1
    vals = _values(n, 3, "int64", seed=p + n)
    res = ref_simulate(p, n, root, keep_buffers=True, payloads=list(vals))
    want = np.stack([np.stack(row) for row in res.buffers])
    got = host_plan("broadcast", p, n, root=root, backend="torch",
                    device="cpu").run(vals)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", PS)
def test_simulate_broadcast_certifies_backend(p):
    for n in NS:
        root = (3 * p) // 4
        mine = simulate_broadcast(p, n, root, backend="torch", device="cpu")
        theirs = ref_simulate(p, n, root)
        assert (mine.rounds, mine.optimal_rounds, mine.messages,
                mine.blocks_moved) == (theirs.rounds, theirs.optimal_rounds,
                                       theirs.messages, theirs.blocks_moved)
        assert mine.backend == "torch"


def test_cuda_backend_resolves_to_the_kernels():
    # On CPU tensors the kernel wrappers take the plain versions, so the
    # "cuda" backend's results are checked on the card (test_torch_cuda.py);
    # here only that the plan holds the kernel round step.
    plan = host_plan("broadcast", 5, 3, root=2, backend="cuda", device="cpu")
    assert isinstance(plan.step, CudaRoundStep)
    assert isinstance(host_plan("broadcast", 5, 3, root=2, backend="torch",
                                device="cpu").step, TorchRoundStep)


def test_p1_is_a_noop():
    vals = _values(4, 3, "float32")
    out = host_plan("broadcast", 1, 4, backend="torch", device="cpu").run(vals)
    assert np.array_equal(out.numpy(), vals[None])
    assert simulate_broadcast(1, 4, backend="torch", device="cpu").rounds == 0


def test_payload_shapes_follow_the_reference():
    # [n] payloads become one-element blocks, [n, a, b] flatten to [n, a*b].
    plan = host_plan("broadcast", 5, 3, root=2, backend="torch", device="cpu")
    assert tuple(plan.run(np.arange(3)).shape) == (5, 3, 1)
    assert tuple(plan.run(np.zeros((3, 2, 4), np.float32)).shape) == (5, 3, 8)
    with pytest.raises(ValueError):
        plan.run(np.zeros((4, 2), np.float32))


def test_plans_are_cached_with_tables_uploaded_once():
    a = host_plan("broadcast", 11, 4, root=3, backend="cuda", device="cpu")
    assert host_plan("broadcast", 11, 4, root=3, backend="cuda",
                     device="cpu") is a
    recv, send = a.device_slots
    assert recv.dtype == torch.int32 and tuple(recv.shape) == (len(a.ks), 11)
    assert np.array_equal(recv.numpy(), a.slots[0])
    assert np.array_equal(send.numpy(), a.slots[1])
    (static,) = a.statics
    assert static.slots[0] is a.slots[0] and static.shifts == a.skips
    assert not static.overlap
    b = host_plan("broadcast", 11, 4, root=3, backend="cuda", overlap=True,
                  device="cpu")
    assert b is not a and b.statics[0].overlap


@pytest.mark.parametrize("bad, match", [
    (dict(overlap=True), "overlap"),
    (dict(op="max"), "sums"),
    (dict(op="+"), "sums"),
    (dict(qblock=0), "qblock"),
])
def test_quantized_allreduce_rejects_bad_arguments(bad, match):
    with pytest.raises(ValueError, match=match):
        host_plan("quantized_allreduce", 5, 3, device="cpu", **bad)


@pytest.mark.parametrize("kind", ["broadcast", "allgather", "reduce"])
def test_qblock_applies_to_the_quantized_kind_only(kind):
    with pytest.raises(ValueError, match="qblock"):
        host_plan(kind, 5, 3, qblock=8, device="cpu")


def test_quantized_allreduce_rejects_a_block_not_a_multiple_of_qblock():
    plan = host_plan("quantized_allreduce", 5, 3, qblock=8, device="cpu")
    assert plan.statics[0].kind == "reduce" and plan.statics[1].kind == "broadcast"
    with pytest.raises(ValueError, match="multiple of qblock"):
        plan.run(np.zeros((5, 3, 12), np.float32))
    with pytest.raises(ValueError):
        plan.run(np.zeros((4, 3, 16), np.float32))


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        host_plan("scatter", 5, 3, device="cpu")
    with pytest.raises(ValueError):
        host_plan("broadcast", 5, 3, backend="pallas", device="cpu")
    with pytest.raises(ValueError):
        host_plan("broadcast", 5, 3, root=5, device="cpu")
