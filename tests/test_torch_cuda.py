"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips, from inside the test, when no CUDA
device is present.  These tests import neither JAX nor the JAX package,
and need no ``conftest.py``, so they run on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact (``torch.equal``) -- the kernels only move data.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import host_plan, simulate_broadcast
from repro_torch.kernels import block_pack as bp
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float64, torch.int64,
          torch.int32, torch.int8]
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
        "block_pack": 1, "block_unpack": 1, "block_shuffle": 1}


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
        "block_pack": 1, "block_unpack": 1, "block_shuffle": rounds - 1}
    want = host_plan("broadcast", p, n, root=root, backend="torch").run(vals)
    assert got.is_cuda and torch.equal(got, want)
    assert torch.equal(got, torch.from_numpy(vals).cuda().expand(p, n, 300))


@pytest.mark.parametrize("p", [2, 5, 36, 64])
def test_simulate_broadcast_certifies_cuda(gen, p):
    assert simulate_broadcast(p, 7, p - 1, backend="cuda").backend == "cuda"
