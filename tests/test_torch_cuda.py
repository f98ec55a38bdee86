"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips, from inside the test, when no CUDA
device is present.  These tests import neither JAX nor the JAX package,
and need no ``conftest.py``, so they run on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact, bit for bit (``torch.equal`` on the bits): the copy
kernels only move data, and the accumulating kernels make the same
single rounding and the same NaN and signed-zero choices as their plain
versions.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    host_plan,
    simulate_allgather,
    simulate_allreduce,
    simulate_broadcast,
    simulate_reduce,
)
from repro_torch.kernels import block_pack as bp
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float64, torch.int64,
          torch.int32, torch.int8]
ACC_DTYPES = DTYPES + [torch.float16, torch.int16]
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
SHAPES = [(1, 4, 8), (37, 6, 131), (64, 9, 4096)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(gen, shape, dtype):
    R, ns, bs = shape
    buf = torch.randint(-100, 100, shape, generator=gen, device="cuda").to(dtype)
    msg = torch.randint(-100, 100, (R, bs), generator=gen, device="cuda").to(dtype)
    recv = torch.randint(0, ns, (R,), generator=gen, device="cuda", dtype=torch.int32)
    send = torch.randint(0, ns, (R,), generator=gen, device="cuda", dtype=torch.int32)
    send[::3] = recv[::3]     # the pipeline case on every third row
    return buf, msg, recv, send


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernels_match_plain(gen, dtype, shape):
    buf, msg, recv, send = _operands(gen, shape, dtype)
    before = dict(bp.LAUNCHES)
    assert torch.equal(bp.block_pack(buf, send), ref.block_pack_ref(buf, send))

    a, b = buf.clone(), buf.clone()
    assert bp.block_unpack(a, msg, recv) is a
    assert torch.equal(a, ref.block_unpack_ref(b, msg, recv))

    a, b = buf.clone(), buf.clone()
    ka, ko = bp.block_shuffle(a, msg, recv, send)
    ra, ro = ref.block_shuffle_ref(b, msg, recv, send)
    assert ka is a and torch.equal(a, b) and torch.equal(ko, ro)
    torch.cuda.synchronize()
    assert {k: bp.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0),
        "block_pack": 1, "block_unpack": 1, "block_shuffle": 1}


def _same_bits(a, b):
    bits = _BITS[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_shuffle_staged_matches_plain(gen, dtype, shape):
    buf, msg, recv, send = _operands(gen, shape, dtype)
    pre = ref.block_pack_ref(buf, send)
    before = bp.LAUNCHES["block_shuffle_staged"]
    a, b = buf.clone(), buf.clone()
    ka, ko = bp.block_shuffle_staged(a, msg, pre, recv, send)
    ra, ro = ref.block_shuffle_staged_ref(b, msg, pre, recv, send)
    assert ka is a and torch.equal(a, b) and torch.equal(ko, ro)
    # and the staged step equals the sequential one
    assert torch.equal(ko, ref.block_shuffle_ref(buf.clone(), msg, recv, send)[1])
    torch.cuda.synchronize()
    assert bp.LAUNCHES["block_shuffle_staged"] - before == 1


def _specials(dtype, shape, gen):
    """Operands with NaN, +-0 and (for floats) values near the extremes."""
    buf, msg, acc, fwd = _operands(gen, shape, dtype)
    if dtype.is_floating_point:
        flat_b, flat_m = buf.view(-1), msg.view(-1)
        flat_b[0::7] = float("nan")
        flat_m[1::11] = float("nan")
        flat_b[2::5] = -0.0
        flat_m[2::5] = 0.0
        flat_b[3::5] = 0.0
        flat_m[3::5] = -0.0
    return buf, msg, acc, fwd


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ACC_DTYPES, ids=str)
def test_acc_shuffles_match_plain(gen, dtype, shape, op):
    buf, msg, acc, fwd = _specials(dtype, shape, gen)
    pre = ref.block_pack_ref(buf, fwd)
    before = dict(bp.LAUNCHES)
    a, b = buf.clone(), buf.clone()
    ka, ko = bp.block_acc_shuffle(a, msg, acc, fwd, op=op)
    ra, ro = ref.block_acc_shuffle_ref(b, msg, acc, fwd, op)
    assert ka is a and _same_bits(a, b) and _same_bits(ko, ro)

    a2, b2 = buf.clone(), buf.clone()
    ka, so = bp.block_acc_shuffle_staged(a2, msg, pre, acc, fwd, op=op)
    ra, sr = ref.block_acc_shuffle_staged_ref(b2, msg, pre, acc, fwd, op)
    assert ka is a2 and _same_bits(a2, b2) and _same_bits(so, sr)
    assert _same_bits(a2, a) and _same_bits(so, ko)   # staged == sequential
    torch.cuda.synchronize()
    assert {k: bp.LAUNCHES[k] - before[k] for k in
            ("block_acc_shuffle", "block_acc_shuffle_staged")} == {
        "block_acc_shuffle": 1, "block_acc_shuffle_staged": 1}


def test_acc_shuffle_keeps_denormals(gen):
    tiny = torch.tensor(1e-45)                    # the least f32 denormal
    buf = torch.zeros((1, 2, 4), device="cuda") + tiny.cuda()
    msg = torch.zeros((1, 4), device="cuda") + tiny.cuda()
    idx = torch.zeros(1, dtype=torch.int32, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    _, out = bp.block_acc_shuffle(buf, msg, idx, one)
    assert torch.equal(buf[0, 0], (tiny + tiny).cuda().expand(4))


def test_kernel_rejects_mixed_devices(gen):
    buf, msg, recv, send = _operands(gen, (8, 4, 16), torch.float32)
    with pytest.raises(ValueError):
        bp.block_pack(buf, send.cpu())


def test_broadcast_cuda_matches_torch(gen):
    p, n, root = 37, 7, 5
    vals = np.random.default_rng(1).standard_normal((n, 300)).astype(np.float32)
    before = dict(bp.LAUNCHES)
    got = host_plan("broadcast", p, n, root=root, backend="cuda").run(vals)
    rounds = len(host_plan("broadcast", p, n, root=root, backend="cuda").ks)
    assert {k: bp.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0),
        "block_pack": 1, "block_unpack": 1, "block_shuffle": rounds - 1}
    want = host_plan("broadcast", p, n, root=root, backend="torch").run(vals)
    assert got.is_cuda and torch.equal(got, want)
    assert torch.equal(got, torch.from_numpy(vals).cuda().expand(p, n, 300))


@pytest.mark.parametrize("p", [2, 5, 36, 64])
def test_simulate_broadcast_certifies_cuda(gen, p):
    assert simulate_broadcast(p, 7, p - 1, backend="cuda").backend == "cuda"


def _launched(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in bp.LAUNCHES.items() if v != before[k]}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64],
                         ids=str)
@pytest.mark.parametrize("op", ["sum", "max"])
def test_reduce_cuda_matches_torch(gen, op, dtype, overlap):
    p, n, root = 37, 7, 5
    vals = torch.randn((p, n, 300), generator=gen, device="cuda").mul(8).to(dtype)
    plan = host_plan("reduce", p, n, root=root, op=op, overlap=overlap)
    R = len(plan.ks)
    before = dict(bp.LAUNCHES)
    got = plan.run(vals)
    want = ({"block_acc_shuffle": 1, "block_pack": R,
             "block_acc_shuffle_staged": R} if overlap
            else {"block_acc_shuffle": R + 1})
    assert _launched(before) == want
    plain = host_plan("reduce", p, n, root=root, op=op, backend="torch",
                      overlap=overlap).run(vals)
    assert got.is_cuda and _same_bits(got, plain)
    if dtype == torch.int64:
        expect = vals.sum(0) if op == "sum" else vals.amax(0)
        assert torch.equal(got[root], expect)


@pytest.mark.parametrize("overlap", [False, True])
def test_allgather_cuda_matches_torch(gen, overlap):
    p, n = 23, 5
    vals = torch.randn((p, n, 40), generator=gen, device="cuda")
    plan = host_plan("allgather", p, n, overlap=overlap)
    R = len(plan.ks)
    before = dict(bp.LAUNCHES)
    got = plan.run(vals)
    want = ({"block_pack": R, "block_shuffle_staged": R - 1, "block_unpack": 1}
            if overlap else
            {"block_pack": 1, "block_shuffle": R - 1, "block_unpack": 1})
    assert _launched(before) == want
    plain = host_plan("allgather", p, n, backend="torch",
                      overlap=overlap).run(vals)
    assert torch.equal(got, plain) and torch.equal(got, vals.expand(p, p, n, 40))


def test_broadcast_overlap_cuda_matches_sequential(gen):
    p, n, root = 37, 7, 5
    vals = torch.randn((n, 300), generator=gen, device="cuda")
    plan = host_plan("broadcast", p, n, root=root, overlap=True)
    R = len(plan.ks)
    before = dict(bp.LAUNCHES)
    got = plan.run(vals)
    assert _launched(before) == {"block_pack": R, "block_shuffle_staged": R - 1,
                                 "block_unpack": 1}
    assert torch.equal(got, host_plan("broadcast", p, n, root=root).run(vals))


@pytest.mark.parametrize("p", [2, 5, 36])
def test_simulators_certify_cuda(gen, p):
    assert simulate_reduce(p, 7, p - 1, op="max", backend="cuda").backend == "cuda"
    assert simulate_allreduce(p, 4, p // 2, backend="cuda").backend == "cuda"
    assert simulate_allgather(p, 4, backend="cuda").backend == "cuda"
