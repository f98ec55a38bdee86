"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips, from inside the test, when no CUDA
device is present.  These tests import neither JAX nor the JAX package,
and need no ``conftest.py``, so they run on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance of the round-step kernels: exact, bit for bit (``torch.equal``
on the bits): the copy
kernels only move data, and the accumulating kernels make the same
single rounding and the same NaN and signed-zero choices as their plain
versions.  The quantized step's float outputs compare NaN lanes by
position (a NaN made by the card's arithmetic carries the card's
payload), every other lane by its bits.

The model kernels (flash attention, the SSD scan) sum in another order
than their plain versions, so they are held allclose: attention at
2e-5 in f32 (as ``tests/test_kernels.py``) and in bf16/f16 at two steps
of the output's precision relative to the plain value plus 1e-5 (both
compute in f32 and round the output once), the scan at 1e-4 (f32, as
``tests/test_kernels.py``); a small
model's ``"cuda"`` prefill equals its ``"torch"`` prefill at 1e-4 in
f32.  TF32 is off for these (``allow_tf32 = False`` for matmul and
cuDNN), so the plain versions' products are full f32.
"""

import copy
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import (
    MoE,
    decode_step,
    encode_memory,
    init_cache,
    init_params,
    layer_pattern,
    moe_apply,
    prefill,
)
from repro_torch.models.moe import route as moe_route
from repro_torch.serve.engine import Request, ServeLoop
from repro_torch.core import (
    StackedGroup,
    get_comm,
    hier_host_plan,
    host_plan,
    simulate_allgather,
    simulate_allreduce,
    simulate_broadcast,
    simulate_hier_allreduce,
    simulate_hier_broadcast,
    simulate_hier_reduce,
    simulate_reduce,
)
from repro_torch.kernels import block_pack as bp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quant_ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.core.tree import tree_flatten
from repro_torch.train.restore_broadcast import broadcast_state

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float64, torch.int64,
          torch.int32, torch.int8]
ACC_DTYPES = DTYPES + [torch.float16, torch.int16]
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
SHAPES = [(1, 4, 8), (37, 6, 131), (64, 9, 4096)]
#: Short rows, which the short-row path of the copy and accumulating
#: kernels takes (fewer than 32 units): in float32, rows of 1, 3, 12, 15,
#: 16, 17, 31, 32 and 33 16-byte units (32 and 33 take the long path); the
#: allgather's and the reduce_scatter's 192-byte rows (p = 1152: 8 KiB a
#: rank in 44 blocks of 48) at 70,000 rows, past any 65,535 grid limit;
#: rows of 5 elements (5 bytes in int8: 1-byte units).  A fourth entry
#: offsets every operand by that many elements, so the unit width falls to
#: the element's (the accumulating kernels: one element a unit).
SHORT_SHAPES = [(300, 5, 4 * u) for u in (1, 3, 12, 15, 16, 17, 31, 32, 33)] + [
    (70_000, 9, 48), (600, 6, 5), (600, 6, 5, 1), (600, 6, 12, 1),
    (600, 6, 48, 1)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _offset(t, off):
    """``t`` copied to a contiguous tensor ``off`` elements past an
    allocation's start (``off`` = 0: ``t`` itself)."""
    if not off:
        return t
    return torch.empty(t.numel() + off, dtype=t.dtype,
                       device=t.device)[off:].view(t.shape).copy_(t)


def _operands(gen, shape, dtype):
    R, ns, bs, *off = shape
    off = off[0] if off else 0
    buf = torch.randint(-100, 100, (R, ns, bs), generator=gen, device="cuda").to(dtype)
    msg = torch.randint(-100, 100, (R, bs), generator=gen, device="cuda").to(dtype)
    buf, msg = _offset(buf, off), _offset(msg, off)
    recv = torch.randint(0, ns, (R,), generator=gen, device="cuda", dtype=torch.int32)
    send = torch.randint(0, ns, (R,), generator=gen, device="cuda", dtype=torch.int32)
    send[::3] = recv[::3]     # the pipeline case on every third row
    return buf, msg, recv, send


@pytest.mark.parametrize("shape", SHAPES + SHORT_SHAPES)
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


def test_copy_kernels_cross_a_slab(gen):
    """Rows of one int8 byte, 2^26 + 5 of them: the short-row launchers
    cover at most 2^26 rows a launch (kSlabRows), so this buffer takes a
    second slab of 5 rows, and an offset wrong there shows in the last
    rows.  The four copy kernels against their plain versions, bit for
    bit, each one count a wrapper call."""
    R = (1 << 26) + 5
    buf, msg, recv, send = _operands(gen, (R, 2, 1), torch.int8)
    before = dict(bp.LAUNCHES)
    assert torch.equal(bp.block_pack(buf, send), ref.block_pack_ref(buf, send))

    a, b = buf.clone(), buf.clone()
    bp.block_unpack(a, msg, recv)
    assert torch.equal(a, ref.block_unpack_ref(b, msg, recv))

    a, b = buf.clone(), buf.clone()
    _, ko = bp.block_shuffle(a, msg, recv, send)
    _, ro = ref.block_shuffle_ref(b, msg, recv, send)
    assert torch.equal(a, b) and torch.equal(ko, ro)

    pre = ref.block_pack_ref(buf, send)
    a, b = buf.clone(), buf.clone()
    _, ko = bp.block_shuffle_staged(a, msg, pre, recv, send)
    _, ro = ref.block_shuffle_staged_ref(b, msg, pre, recv, send)
    assert torch.equal(a, b) and torch.equal(ko, ro)
    torch.cuda.synchronize()
    assert {k: bp.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "block_pack": 1, "block_unpack": 1,
        "block_shuffle": 1, "block_shuffle_staged": 1}


def _same_bits(a, b):
    bits = _BITS[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("shape", SHAPES + SHORT_SHAPES)
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
@pytest.mark.parametrize("shape", SHAPES + SHORT_SHAPES)
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


def test_acc_shuffles_cross_a_slab(gen):
    """The accumulating kernels' counterpart of
    test_copy_kernels_cross_a_slab: rows of one int8 element, 2^26 + 5 of
    them, so the short-row launcher takes a second slab of 5 rows.  Both
    kernels against their plain versions, bit for bit, one launch each."""
    R = (1 << 26) + 5
    buf, msg, acc, fwd = _operands(gen, (R, 2, 1), torch.int8)
    pre = ref.block_pack_ref(buf, fwd)
    before = dict(bp.LAUNCHES)
    a, b = buf.clone(), buf.clone()
    _, ko = bp.block_acc_shuffle(a, msg, acc, fwd)
    _, ro = ref.block_acc_shuffle_ref(b, msg, acc, fwd, "sum")
    assert torch.equal(a, b) and torch.equal(ko, ro)

    a, b = buf.clone(), buf.clone()
    _, ko = bp.block_acc_shuffle_staged(a, msg, pre, acc, fwd)
    _, ro = ref.block_acc_shuffle_staged_ref(b, msg, pre, acc, fwd, "sum")
    assert torch.equal(a, b) and torch.equal(ko, ro)
    torch.cuda.synchronize()
    assert {k: bp.LAUNCHES[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "block_acc_shuffle": 1,
        "block_acc_shuffle_staged": 1}


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


def _hier_launches(plan):
    """The kernel launches of one run of a hier host plan: a forward level
    of R rounds packs once, shuffles R - 1 times and unpacks once, a
    reduce level acc_shuffles R + 1 times; the intra level of the reduce
    and the allgather runs once a node, that of the broadcast once."""
    want = dict.fromkeys(("block_pack", "block_shuffle", "block_unpack",
                          "block_acc_shuffle"), 0)
    levels = []
    for level, times in ((plan.inter, 1), (plan.intra, plan.nodes)):
        for flat in (level if isinstance(level, tuple) else (level,)):
            if flat is not None:
                levels.append((flat, 1 if flat.kind == "broadcast" else times))
    for flat, times in levels:
        R = len(flat.ks)
        if flat.kind == "reduce":
            want["block_acc_shuffle"] += times * (R + 1)
        else:
            want["block_pack"] += times
            want["block_shuffle"] += times * (R - 1)
            want["block_unpack"] += times
    return {k: v for k, v in want.items() if v}


#: (nodes, cores, n_inter, n_intra, m, op): the last case pads m = 301
#: into 7 and 9 blocks.
HIER_CASES = [(2, 3, 2, 3, 12, "sum"), (5, 4, 3, 2, 300, "max"),
              (36, 32, 5, 4, 400, "sum"), (5, 4, 7, 9, 301, "sum")]


@pytest.mark.parametrize("nodes,cores,nN,nC,m,op", HIER_CASES)
@pytest.mark.parametrize("kind", ["broadcast", "reduce", "allreduce", "allgather"])
def test_hier_cuda_matches_torch(gen, kind, nodes, cores, nN, nC, m, op):
    root = nodes * cores - 1 if kind != "allgather" else 0
    shape = (m,) if kind == "broadcast" else (nodes, cores, m)
    vals = torch.randn(shape, generator=gen, device="cuda")
    plan = hier_host_plan(kind, nodes, cores, nN, nC, root=root, op=op)
    before = dict(bp.LAUNCHES)
    got = plan.run(vals)
    assert _launched(before) == _hier_launches(plan)
    want = hier_host_plan(kind, nodes, cores, nN, nC, root=root, op=op,
                          backend="torch").run(vals)
    assert got.is_cuda and _same_bits(got, want)
    if kind == "broadcast":
        assert torch.equal(got, vals.expand(nodes, cores, m))
    elif kind == "allgather":
        assert torch.equal(got, vals.view(nodes * cores, m))


@pytest.mark.parametrize("kind,op", [("broadcast", "sum"), ("reduce", "sum"),
                                     ("reduce", "max"), ("allreduce", "sum"),
                                     ("allgather", "sum"), ("allbroadcast", "sum")])
def test_hiercomm_cuda_matches_torch(gen, kind, op):
    """get_hier_comm(StackedGrid(3, 4)): each kind's "cuda" plan on a
    mixed-dtype pytree (padded blocks at both levels, root 7: node 1,
    core 3) bit for bit against the "torch" plan, with its launches."""
    from repro_torch.core.hier import StackedGrid, get_hier_comm

    grid = StackedGrid(3, 4)
    p = grid.p
    if kind in ("allgather", "allbroadcast"):
        x = {"x": torch.randn((p * 61,), generator=gen, device="cuda"),
             "y": torch.randint(-99, 99, (p, 3, 5), generator=gen, device="cuda",
                                dtype=torch.int32)}
        kw = {}
    else:
        x = {"w": torch.randn((p, 301), generator=gen, device="cuda"),
             "b": torch.randint(-2 ** 31, 2 ** 31, (p, 7, 11), generator=gen,
                                device="cuda", dtype=torch.int32),
             "t": (torch.randn((p, 45), generator=gen, device="cuda").to(torch.bfloat16),)}
        kw = {"root": 7} if kind == "broadcast" else {"root": 7, "op": op}
    plan = get_hier_comm(grid).plan(kind, x, n_inter=2, n_intra=3, **kw)
    plain = get_hier_comm(grid, backend="torch").plan(kind, x, n_inter=2, n_intra=3, **kw)
    before = dict(bp.LAUNCHES)
    out = plan(x)
    got = tree_flatten(out)[0]
    assert _launched(before) == comm_launches(plan, len(got))
    want = tree_flatten(plain(x))[0]
    for g, w in zip(got, want):
        assert g.is_cuda and _same_bits(g.contiguous(), w.contiguous())
    if plan.kind == "allgather":
        for g, w in zip(tree_flatten(plan.per_rank(x))[0], tree_flatten(x)[0]):
            assert g.shape == (p,) + w.shape and torch.equal(g, w.expand_as(g))
    elif kind == "reduce" and op == "sum":
        assert torch.equal(out["b"][7], x["b"].sum(0, dtype=torch.int32))
    elif kind == "broadcast":
        assert torch.equal(out["w"], x["w"][7].expand(p, 301))


def test_simulate_hier_certifies_cuda(gen):
    # the reference test's 36 x 32 arguments (tests/test_hier.py)
    assert simulate_hier_broadcast(36, 32, 3, 2, root=35 * 32 + 7,
                                   backend="cuda").backend == "cuda"
    assert simulate_hier_reduce(36, 32, 2, 2, root=100, op="max",
                                backend="cuda").backend == "cuda"
    assert simulate_hier_allreduce(36, 32, 2, 1, backend="cuda").backend == "cuda"


def _same_or_nan(a, b):
    """Equal bits, NaN lanes by position (the card's NaN payload is its
    own choice)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0, a).view(_BITS[a.element_size()]),
        torch.where(nan, 0, b).view(_BITS[a.element_size()]))


def _qacc_operands(gen, R, S, qb, nbk):
    """High-dynamic-range f32 buffer and error, an int8 message quantized
    from it, about a third of the rows coincident, and NaN, inf, zero
    and tiny (scale-floor) blocks."""
    bs = qb * nbk
    scale = 10.0 ** torch.randint(-4, 5, (R, S, nbk, 1), generator=gen,
                                  device="cuda").float()
    buf = (torch.randn((R, S, nbk, qb), generator=gen, device="cuda")
           * scale).view(R, S, bs)
    err = torch.randn((R, S, bs), generator=gen, device="cuda") * 1e-3
    src = torch.randn((R * nbk, qb), generator=gen, device="cuda")
    q, s = quant_ops.quant_blocks(src * 10.0)
    q, s = q.view(R, bs).contiguous(), s.view(R, nbk).contiguous()
    acc = torch.randint(0, S, (R,), generator=gen, device="cuda", dtype=torch.int32)
    fwd = torch.randint(0, S, (R,), generator=gen, device="cuda", dtype=torch.int32)
    fwd[::3] = acc[::3]
    buf[0, :, :qb] = 0.0                          # scale floor
    buf[min(1, R - 1), :, qb - 1] = 1e-13         # tiny: floored scale too
    buf[R // 2, fwd[R // 2], bs - 1] = float("nan")
    buf[R - 1, fwd[R - 1], 0] = float("inf")
    s[R // 2, nbk - 1] = float("nan")             # an incoming flagged block
    return buf, err, q, s, acc, fwd


@pytest.mark.parametrize("R,S,qb,nbk", [(1, 3, 8, 1), (37, 6, 8, 5),
                                        (37, 4, 256, 3), (9, 5, 3, 7),
                                        (16, 4, 1024, 2), (5, 3, 2048, 2)])
def test_qacc_shuffle_matches_plain(gen, R, S, qb, nbk):
    buf, err, q, s, acc, fwd = _qacc_operands(gen, R, S, qb, nbk)
    a, ea = buf.clone(), err.clone()
    b, eb = buf.clone(), err.clone()
    before = bp.LAUNCHES["block_qacc_shuffle"]
    got = bp.block_qacc_shuffle(a, ea, q, s, acc, fwd)
    want = ref.block_qacc_shuffle_ref(b, eb, q, s, acc, fwd)
    torch.cuda.synchronize()
    assert bp.LAUNCHES["block_qacc_shuffle"] - before == 1
    assert got[0] is a and got[1] is ea
    for k, r in zip(got, want):
        assert _same_or_nan(k, r)
    assert torch.isfinite(ea).all()
    # NaN scales are the canonical quiet NaN, as the plain version's
    assert torch.equal(got[3].view(torch.int32), want[3].view(torch.int32))


def test_qacc_shuffle_unaligned_operands_take_the_scalar_path(gen):
    R, S, qb, nbk = 7, 3, 8, 2
    buf, err, q, s, acc, fwd = _qacc_operands(gen, R + 1, S, qb, nbk)
    qbig = torch.zeros(R * qb * nbk + 1, dtype=torch.int8, device="cuda")
    qv = qbig[1:].view(R, qb * nbk)               # 1-byte aligned message
    qv.copy_(q[:R])
    a, ea = buf[:R].clone(), err[:R].clone()
    b, eb = buf[:R].clone(), err[:R].clone()
    got = bp.block_qacc_shuffle(a, ea, qv, s[:R].contiguous(), acc[:R].contiguous(),
                                fwd[:R].contiguous())
    want = ref.block_qacc_shuffle_ref(b, eb, qv, s[:R].contiguous(),
                                      acc[:R].contiguous(), fwd[:R].contiguous())
    for k, r in zip(got, want):
        assert _same_or_nan(k, r)


@pytest.mark.parametrize("p,n,root", [(2, 1, 0), (37, 7, 5), (36, 4, 35)])
def test_quantized_allreduce_cuda_matches_torch(gen, p, n, root):
    qb = 8
    vals = (torch.randn((p, n, 5 * qb), generator=gen, device="cuda")
            * 10.0 ** torch.randint(-4, 5, (p, n, 1), generator=gen,
                                    device="cuda").float())
    vals[1, 0, qb] = float("nan")
    plan = host_plan("quantized_allreduce", p, n, root=root, qblock=qb)
    R = len(plan.ks)
    before = dict(bp.LAUNCHES)
    out, err = plan.run(vals)
    want = {"block_qacc_shuffle": R + 1, "block_pack": 2,
            "block_shuffle": 2 * (R - 1), "block_unpack": 2}
    assert _launched(before) == {k: v for k, v in want.items() if v}
    plain = host_plan("quantized_allreduce", p, n, root=root, qblock=qb,
                      backend="torch")
    pout, perr = plain.run(vals)
    assert out.is_cuda and _same_or_nan(out, pout) and _same_or_nan(err, perr)
    assert all(_same_or_nan(out[r], out[0]) for r in range(p))
    # second step with error feedback
    vals2 = torch.randn((p, n, 5 * qb), generator=gen, device="cuda") + err
    o2, e2 = plan.run(vals2)
    po2, pe2 = plain.run(vals2)
    assert _same_or_nan(o2, po2) and _same_or_nan(e2, pe2)


# ------------------------------------------------------------ model kernels

#: (atol, rtol): f32 as tests/test_kernels.py; bf16/f16 two output steps
#: (2^-7 and 2^-10 of |want| each) plus 1e-5 for f32 sums near zero.
_ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-5, 2.0 ** -6),
             torch.float16: (1e-5, 2.0 ** -9)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=str)
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", [
    (1, 64, 4, 4, 32, True, None),       # one block
    (2, 100, 4, 2, 32, True, None),      # GQA, ragged sequence
    (2, 37, 2, 1, 64, False, None),      # odd sequence, non-causal
    (1, 300, 8, 2, 80, True, None),      # zamba2's head width
    (1, 333, 4, 2, 80, True, 70),        # sliding window, hd 80
    (2, 130, 3, 3, 128, True, None),     # widest head
    (1, 17, 2, 2, 5, False, None),       # tiny odd head
])
def test_flash_attention_matches_plain(gen, dtype, B, S, H, Hkv, hd, causal,
                                       window):
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 1
    want = fa.blocked_attention(q, k, v, causal, window, q_chunk=64, kv_chunk=32)
    assert out.dtype == dtype and out.shape == (B, S, H, hd)
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=str)
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,hd", [
    (2, 200, 1601, 8, 2, 128),   # vlm cross-attention: heads of 128, GQA
    (2, 1, 1601, 8, 2, 128),     # its decode: one query row in a 64-row block
    (2, 448, 1500, 4, 4, 64),    # whisper cross-attention
    (3, 1, 1500, 4, 4, 64),      # its decode
    (1, 1500, 1500, 4, 4, 64),   # whisper's encoder: non-causal self
    (2, 70, 33, 4, 2, 80),       # more queries than keys
])
def test_flash_attention_cross_shapes(gen, dtype, B, Sq, Skv, H, Hkv, hd):
    """Non-causal attention with Sq != Skv, as cross-attention runs it:
    1601 and 1500 keys end in a partial 64-key block."""
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=gen, device="cuda").to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 1
    assert out.dtype == dtype and out.shape == (B, Sq, H, hd)
    want = fa.blocked_attention(q, k, v, False, q_chunk=128, kv_chunk=256)
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_attention_value_width_differs(gen):
    q = torch.randn((2, 90, 4, 48), generator=gen, device="cuda")
    k = torch.randn((2, 90, 2, 48), generator=gen, device="cuda")
    v = torch.randn((2, 90, 2, 72), generator=gen, device="cuda")
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.blocked_attention(q, k, v, True),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("B,S,H,Hkv,hd,hd_v,causal,window", [
    (1, 200, 2, 1, 5, 5, True, None),        # tiny odd head, plain-load path
    (1, 200, 4, 2, 40, 40, True, None),      # hd 40, S not a tile multiple
    (2, 1000, 4, 1, 80, 80, True, None),     # zamba2's head over 16 key tiles
    (1, 257, 2, 2, 128, 128, False, None),   # widest head, non-causal
    (1, 190, 4, 2, 48, 72, True, None),      # hd_v != hd
    (1, 150, 2, 1, 80, 64, True, None),      # hd_v < hd
    (1, 300, 4, 2, 64, 64, True, 50),        # window inside a tile
    (1, 600, 2, 1, 80, 80, True, 97),        # window straddling tiles
])
def test_flash_attention_mma_edges(gen, dtype, B, S, H, Hkv, hd, hd_v, causal,
                                   window):
    """The tensor-core kernel at its edges: ragged sequences and heads,
    value width other than the key width, windows across tile borders."""
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, hd_v), generator=gen, device="cuda").to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 1
    assert out.dtype == dtype and out.shape == (B, S, H, hd_v)
    want = fa.blocked_attention(q, k, v, causal, window, q_chunk=128, kv_chunk=64)
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("window", [None, 90], ids=["causal", "window"])
def test_flash_attention_wide_head_cuda_cores(gen, dtype, window):
    """bf16/f16 heads wider than 128 run the CUDA-core kernel (but the
    192/128 and 160/160 pairs, which the tensor cores take: here q and k
    heads of 160 with v heads of 128)."""
    q = torch.randn((1, 230, 4, 160), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, 230, 2, 160), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, 230, 2, 128), generator=gen, device="cuda").to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 1
    assert out.dtype == dtype and out.shape == (1, 230, 4, 128)
    want = fa.blocked_attention(q, k, v, True, window, q_chunk=64, kv_chunk=32)
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("B,S,H,Hkv,hd,hd_v,causal,window", [
    (1, 64, 2, 2, 192, 128, True, None),     # one block
    (2, 300, 4, 4, 192, 128, True, None),    # ragged sequence
    (1, 257, 4, 2, 192, 128, False, None),   # non-causal, GQA, ragged
    (1, 333, 2, 2, 192, 128, True, 70),      # window straddling tiles
    (1, 150, 3, 3, 184, 120, True, None),    # narrower widths, same tiles
])
def test_flash_attention_mla_widths(gen, dtype, B, S, H, Hkv, hd, hd_v, causal,
                                    window):
    """MLA's widths (q and k heads of 192 = 128 nope + 64 rope, v heads of
    128) on the tensor-core instance sized to them."""
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, hd_v), generator=gen, device="cuda").to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 1
    assert out.dtype == dtype and out.shape == (B, S, H, hd_v)
    want = fa.blocked_attention(q, k, v, causal, window, q_chunk=128, kv_chunk=64)
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("B,S,H,Hkv,hd,hd_v,causal,window", [
    (1, 64, 2, 2, 160, 160, True, None),     # one block
    (2, 300, 4, 1, 160, 160, True, None),    # GQA, ragged sequence
    (1, 257, 4, 2, 160, 160, False, None),   # non-causal, ragged
    (1, 333, 2, 2, 160, 160, True, 70),      # window straddling tiles
    (1, 150, 3, 3, 150, 150, True, None),    # narrower widths, same tiles, plain loads
    (1, 190, 4, 2, 128, 160, True, None),    # hd 128, hd_v 160: the CUDA cores
])
def test_flash_attention_160_widths(gen, dtype, B, S, H, Hkv, hd, hd_v, causal,
                                    window):
    """stablelm-12b's heads of 160: bf16 and f16 on the tensor-core
    instance sized to them (10 q/k tiles, 20 output tiles), f32 on the
    CUDA-core kernel with 10 output columns a thread."""
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, hd_v), generator=gen, device="cuda").to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 1
    assert out.dtype == dtype and out.shape == (B, S, H, hd_v)
    want = fa.blocked_attention(q, k, v, causal, window, q_chunk=128, kv_chunk=64)
    atol, rtol = _ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_attention_refuses_heads_wider_than_160(gen):
    """A v head above the widest instance's 160 raises on the card, as on
    the CPU; no launch is counted."""
    q = torch.randn((1, 64, 2, 64), generator=gen, device="cuda")
    before = fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="hd_v 161 > 160"):
        fa.flash_attention(q, q, torch.zeros((1, 64, 2, 161), device="cuda"))
    assert fa.LAUNCHES["flash_attention"] == before


def test_flash_attention_mma_unaligned_operands(gen):
    """Operands off a 16-byte boundary take the plain-load path."""
    buf = torch.randn((3 * 130 * 2 * 64 + 1,), generator=gen, device="cuda")
    buf = buf.to(torch.bfloat16)
    q, k, v = (buf[1 + i * 130 * 2 * 64:1 + (i + 1) * 130 * 2 * 64].view(1, 130, 2, 64)
               for i in range(3))
    assert q.data_ptr() % 16 and q.is_contiguous()
    out = fa.flash_attention(q, k, v)
    want = fa.blocked_attention(q, k, v, True)
    torch.testing.assert_close(out.float(), want.float(), atol=1e-5, rtol=2.0 ** -6)


def _ssd_operands(gen, B, S, H, P, G, N):
    x = torch.randn((B, S, H, P), generator=gen, device="cuda")
    Bm = torch.randn((B, S, G, N), generator=gen, device="cuda")
    Cm = torch.randn((B, S, G, N), generator=gen, device="cuda")
    dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=gen, device="cuda")
    A_log = torch.log(0.5 + 1.5 * torch.rand((H,), generator=gen, device="cuda"))
    D = torch.randn((H,), generator=gen, device="cuda")
    return x, Bm, Cm, dt, A_log, D


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 64, 2, 8, 1, 4, 16),
    (1, 70, 4, 16, 2, 8, 32),            # G 2, ragged last chunk
    (1, 17, 1, 4, 1, 2, 8),              # tiny, odd
    (1, 600, 4, 64, 1, 64, 256),         # zamba2's widths, ragged
    (1, 300, 2, 64, 1, 128, 256),        # mamba2-780m's N
    (2, 200, 4, 80, 2, 24, 96),          # P not a power of two
    (1, 50, 2, 128, 1, 16, 1000),        # widest head, chunk > S
])
def test_ssd_scan_matches_plain(gen, B, S, H, P, G, N, chunk):
    ops = _ssd_operands(gen, B, S, H, P, G, N)
    before = ss.LAUNCHES["ssd_scan"]
    y = ss.ssd_scan(*ops, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] - before == 1
    torch.testing.assert_close(y, ss.ssd_chunked(*ops, chunk), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 4096, 2, 64, 1, 64, 256),        # many chunks, small H
    (2, 256, 3, 64, 1, 64, 256),         # exactly one chunk
    (1, 512, 2, 64, 1, 128, 256),        # N 128 (mamba2-780m)
    (1, 700, 4, 32, 2, 16, 160),         # G 2, chunk not a tile multiple
])
def test_ssd_scan_phases_match_plain(gen, B, S, H, P, G, N, chunk):
    """Each CUDA phase against its plain phase on the same inputs, and
    the whole scan against the plain scan."""
    x, Bm, Cm, dt, A_log, D = ops = _ssd_operands(gen, B, S, H, P, G, N)
    cum, sloc = ss.chunk_states(*ops, chunk=chunk)
    want_cum, want_sloc = ss.ssd_chunk_states(x, Bm, dt, A_log, chunk)
    torch.testing.assert_close(cum, want_cum, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sloc, want_sloc, atol=1e-4, rtol=1e-4)
    s_prev = ss.state_pass(want_cum, want_sloc.clone())
    want_prev = ss.ssd_state_pass(want_cum, want_sloc)
    torch.testing.assert_close(s_prev, want_prev, atol=1e-4, rtol=1e-4)
    y = ss.chunk_outputs(*ops, want_cum, want_prev, chunk=chunk)
    want_y = ss.ssd_chunk_outputs(x, Bm, Cm, dt, D, want_cum, want_prev, chunk)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    before = ss.LAUNCHES["ssd_scan"]
    got = ss.ssd_scan(*ops, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] - before == 1
    torch.testing.assert_close(got, ss.ssd_chunked(*ops, chunk), atol=1e-4, rtol=1e-4)


def test_ssd_phases_reject_states_that_do_not_fit(gen):
    """The phase wrappers check the scratch they are handed before a launch
    could read past it."""
    ops = _ssd_operands(gen, 1, 70, 4, 8, 2, 6)
    cum, sloc = ss.chunk_states(*ops, chunk=16)
    with pytest.raises(ValueError, match="do not fit"):
        ss.chunk_outputs(*ops, cum[:, :2].contiguous(), sloc, chunk=16)
    with pytest.raises(ValueError, match="do not fit"):
        ss.state_pass(cum, sloc[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="float32"):
        ss.chunk_outputs(*ops, cum, sloc.double(), chunk=16)


def test_model_kernels_refuse_too_much_shared_memory(gen):
    # A head of 1024 (attention) or a state of 1024 x 64 (scan) needs more
    # shared memory than a block may have: the launch is refused and raises.
    q = torch.randn((1, 8, 1, 1024), generator=gen, device="cuda")
    before = fa.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="flash_attention failed"):
        fa.flash_attention(q, q, q[..., :64].contiguous())
    assert fa.LAUNCHES["flash_attention"] == before
    ops = _ssd_operands(gen, 1, 8, 1, 64, 1, 1024)
    before = ss.LAUNCHES["ssd_scan"]
    with pytest.raises(RuntimeError, match="ssd_scan failed"):
        ss.ssd_scan(*ops, chunk=8)
    assert ss.LAUNCHES["ssd_scan"] == before


def test_model_kernels_reject_mixed_devices_and_layouts(gen):
    q = torch.randn((1, 8, 2, 16), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="operands on"):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    ops = list(_ssd_operands(gen, 1, 8, 2, 4, 1, 4))
    ops[3] = ops[3].cpu()
    with pytest.raises(ValueError, match="operands on"):
        ss.ssd_scan(*ops)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "h2o-danube-1.8b", "mamba2-780m",
                                  "zamba2-2.7b", "granite-3-2b", "stablelm-12b",
                                  "stablelm-12b-hd160"])
def test_model_prefill_cuda_matches_torch(gen, arch):
    """A SMOKE config's f32 prefill on the card ("stablelm-12b-hd160":
    stablelm's SMOKE with its FULL config's heads of 160) launches one
    kernel an attention layer and one a mamba layer, and equals the
    "torch" backend."""
    arch, fields = {"stablelm-12b-hd160": ("stablelm-12b", {"head_dim": 160})}.get(
        arch, (arch, {}))
    cfg = replace(get_config(arch, smoke=True), dtype="float32", **fields)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 70), generator=gen, device="cuda")
    pattern, R, shared = layer_pattern(cfg)
    before = fa.LAUNCHES["flash_attention"], ss.LAUNCHES["ssd_scan"]
    got = prefill(params, cfg, tok)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES["flash_attention"] - before[0],
            ss.LAUNCHES["ssd_scan"] - before[1]) == (
        R * (pattern.count("attn") + shared), R * pattern.count("ssm"))
    want = prefill(params, cfg, tok, backend="torch")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_memory_model_cuda_matches_torch(gen, arch):
    """The vlm and encdec families in f32, cross-attention gates at 0.5:
    prefill launches one kernel an attention layer (the encoder's too),
    decode one a cross-attention layer a step, and both equal the
    "torch" backend."""
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    for layer in params.layers:
        if layer.typ == "xattn":
            layer.gate.fill_(0.5)
    T = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    mem = torch.randn((2, T, cfg.d_model), generator=gen, device="cuda")
    tok = torch.randint(0, cfg.vocab, (2, 70), generator=gen, device="cuda")
    pattern, R, _ = layer_pattern(cfg)
    before = fa.LAUNCHES["flash_attention"]
    got = prefill(params, cfg, tok, memory_embeds=mem)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == (
        R * len(pattern) + R * pattern.count("dec") + cfg.encoder_layers)
    want = prefill(params, cfg, tok, memory_embeds=mem, backend="torch")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    cache = init_cache(cfg, 2, 16, memory=encode_memory(params, cfg, mem))
    plain = {k: v.cpu() for k, v in cache.items()}
    cpu_params = copy.deepcopy(params).cpu()
    for i in range(4):
        before = fa.LAUNCHES["flash_attention"]
        logits, cache = decode_step(params, cfg, cache, tok[:, i:i + 1])
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] - before == R * (
            pattern.count("xattn") + pattern.count("dec"))
        want, plain = decode_step(cpu_params, cfg, plain, tok[:, i:i + 1].cpu())
        torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", ["random", "ties", "overflow", "decode"])
def test_moe_apply_cuda_matches_cpu(gen, case):
    """The moe block on the card against the CPU in f32: the same expert
    indices, rows and drops (CUDA's stable sorts and accumulating
    ``index_put``), out and aux within 1e-5.  "ties": two equal router
    columns on inputs whose logits are exact; "overflow" and "decode"
    (4 tokens, C = 1): one expert takes every token first."""
    cfg = replace(get_config("deepseek-moe-16b", smoke=True), dtype="float32")
    d, E = cfg.d_model, cfg.moe.n_experts
    cpu = MoE(torch.Generator().manual_seed(1), cfg, torch.float32)
    g = torch.Generator().manual_seed(2)
    shape = (4, 1, d) if case == "decode" else (2, 64, d)
    x = torch.randn(shape, generator=g)
    if case == "ties":
        cpu.router.data = torch.randint(-2, 3, (d, E), generator=g) * 0.125
        cpu.router.data[:, 2] = cpu.router[:, 1]
        x = torch.randint(-2, 3, shape, generator=g) * 0.25
    elif case != "random":
        cpu.router.data[:, 0] += 4 * cpu.router.abs().max()
        x = x.abs()
    card = copy.deepcopy(cpu).cuda()
    want, want_aux = moe_apply(cpu, x, cfg)
    got, aux = moe_apply(card, x.cuda(), cfg)
    r_cpu, _ = moe_route(cpu, x.reshape(-1, d), cfg)
    r, _ = moe_route(card, x.cuda().reshape(-1, d), cfg)
    for name in ("expert", "pos", "keep"):
        assert torch.equal(getattr(r, name).cpu(), getattr(r_cpu, name)), name
    if case in ("overflow", "decode"):
        assert not bool(r_cpu.keep.all())
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-5, rtol=1e-5)


def test_moe_model_cuda_matches_torch(gen):
    """deepseek-moe-smoke in f32: prefill launches one kernel a layer and
    equals the "torch" backend; decode steps over 4 slots (C = 1) equal
    the CPU's."""
    cfg = replace(get_config("deepseek-moe-16b", smoke=True), dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (4, 70), generator=gen, device="cuda")
    before = fa.LAUNCHES["flash_attention"]
    got = prefill(params, cfg, tok)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == cfg.n_layers
    want = prefill(params, cfg, tok, backend="torch")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    cache = init_cache(cfg, 4, 16)
    plain = {k: v.cpu() for k, v in cache.items()}
    cpu_params = copy.deepcopy(params).cpu()
    for i in range(4):
        logits, cache = decode_step(params, cfg, cache, tok[:, i:i + 1])
        want, plain = decode_step(cpu_params, cfg, plain, tok[:, i:i + 1].cpu())
        torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)


def test_mla_model_cuda_matches_torch(gen):
    """deepseek-v3-smoke in f32: prefill launches one kernel a layer (at
    MLA's q/k width, nope + rope) and equals the "torch" backend and the
    CPU; absorbed decode steps over 4 slots (C = 1) equal the CPU's."""
    cfg = replace(get_config("deepseek-v3-671b", smoke=True), dtype="float32")
    m = cfg.mla
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    cpu_params = copy.deepcopy(params).cpu()
    tok = torch.randint(0, cfg.vocab, (4, 70), generator=gen, device="cuda")
    fa.reset_launches()
    got = prefill(params, cfg, tok)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BY_SHAPE == {
        (True, 70, 70, cfg.n_heads, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim):
        cfg.n_layers}
    torch.testing.assert_close(got, prefill(params, cfg, tok, backend="torch"),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), prefill(cpu_params, cfg, tok.cpu()),
                               atol=1e-4, rtol=1e-4)
    cache = init_cache(cfg, 4, 16)
    assert set(cache) == {"pos_idx", "pos0_ckv", "pos0_kr"}
    plain = {k: v.cpu() for k, v in cache.items()}
    for i in range(4):
        logits, cache = decode_step(params, cfg, cache, tok[:, i:i + 1])
        want, plain = decode_step(cpu_params, cfg, plain, tok[:, i:i + 1].cpu())
        torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
    for key, value in plain.items():
        torch.testing.assert_close(cache[key].cpu(), value, atol=1e-5, rtol=1e-5)


def test_serve_loop_on_the_card(gen):
    cfg = get_config("zamba2-2.7b", smoke=True)
    loop = ServeLoop(cfg, init_params(cfg), batch_slots=2, max_seq=32)
    reqs = [Request(i, torch.randint(0, cfg.vocab, (n,), generator=gen,
                                     device="cuda").tolist(), max_new=5)
            for i, n in enumerate((4, 6, 3))]
    for r in reqs:
        loop.submit(r)
    loop.run()
    assert all(r.done and len(r.out) == 5 for r in reqs)


# ------------------------------------------------- the communicator


def comm_launches(plan, buffers):
    """The launches one call of a communicator plan (flat or hier) makes:
    ``buffers`` round-step buffers (one a leaf; allgatherv: one a leaf
    and block size) each take a forward phase of R rounds (pack once,
    shuffle R - 1 times, unpack once; overlapped: the pack once a round,
    the staged shuffle) or a reversed phase (R + 1 acc_shuffles;
    overlapped: one acc_shuffle, then a pack and a staged acc_shuffle a
    round); R is the phase's own (a hier plan's levels differ).  A hier
    plan has no overlapped loop."""
    overlap = getattr(plan, "overlap", False)
    out = {}

    def add(name, k):
        out[name] = out.get(name, 0) + k * buffers

    for phase in plan.statics:
        R = phase.ks.shape[0]
        if phase.direction == "fwd":
            add("block_pack", R if overlap else 1)
            add("block_shuffle_staged" if overlap else "block_shuffle", R - 1)
            add("block_unpack", 1)
        elif overlap:
            add("block_acc_shuffle", 1)
            add("block_pack", R)
            add("block_acc_shuffle_staged", R)
        else:
            add("block_acc_shuffle", R + 1)
    return {k: v for k, v in out.items() if v}


def _comm_case(gen, kind, p, elems):
    """A seeded payload for ``kind`` at p with about ``elems`` elements a
    rank, mixed dtypes where the kind takes them -> (payload, plan kwargs,
    round-step buffers a call)."""
    def f32(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def i32(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device="cuda", dtype=torch.int32)

    if kind in ("broadcast", "reduce", "allreduce"):
        x = {"w": f32(p, elems), "b": i32(p, elems // 3 + 1),
             "t": (f32(p, 5).to(torch.bfloat16),)}
        return x, {"root": p // 3}, 3
    if kind in ("allgather", "allbroadcast"):
        return {"x": f32(p * elems), "y": i32(p, 4)}, {}, 2
    if kind == "allgatherv":
        sizes = torch.randint(1, elems + 1, (p,), generator=gen,
                              device="cuda").tolist()
        x = {"v": i32(p, elems), "u": f32(p, elems)}
        n = get_comm(StackedGroup(p)).plan("allgatherv", x, sizes=sizes).n_blocks
        return x, {"sizes": sizes}, 2 * len({max(1, -(-s // n)) for s in sizes})
    shard = -(-elems // p)
    return {"m": f32(p, p * shard), "h": f32(p, p * 3).to(torch.bfloat16)}, {}, 2


COMM_KINDS = ["broadcast", "allgather", "allbroadcast", "allgatherv",
              "reduce_scatter", "reduce", "allreduce"]


@pytest.mark.parametrize("kind,overlap", [(k, ov) for k in COMM_KINDS
                                          for ov in (False, True)
                                          if not (ov and k == "allgatherv")])
@pytest.mark.parametrize("p", [2, 5, 37])
def test_comm_cuda_matches_torch(gen, kind, p, overlap):
    x, kw, buffers = _comm_case(gen, kind, p, 300)
    group = StackedGroup(p)
    plan = get_comm(group).plan(kind, x, overlap=overlap, **kw)
    plain = get_comm(group, backend="torch").plan(kind, x, overlap=overlap, **kw)
    before = dict(bp.LAUNCHES)
    got = plan(x)
    assert _launched(before) == comm_launches(plan, buffers)
    want = plain(x)
    for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert g.is_cuda and _same_bits(g.contiguous(), w.contiguous())
    if plan.kind in ("allgather", "allgatherv"):     # every rank's copy
        for g, w in zip(tree_flatten(plan.per_rank(x))[0],
                        tree_flatten(plain.per_rank(x))[0]):
            assert g.shape[0] == p and _same_bits(g.contiguous(), w.contiguous())
    if kind == "reduce":
        y = {"w": x["w"], "b": x["b"]}
        mx = get_comm(group).reduce(y, op="max", overlap=overlap, **kw)
        assert torch.equal(mx["w"][kw["root"]], x["w"].amax(0))
        assert torch.equal(mx["b"][kw["root"]], x["b"].amax(0))


def test_comm_cuda_matches_torch_at_1152(gen):
    """p = 1152: broadcast, reduce (sum and max) and allreduce at 1 MiB a
    rank, reduce_scatter with 1 MiB rows, the allgathers at 2 KiB a rank
    (their stacked buffer holds p * p rows), each rank's copy of their
    result held against the first."""
    p = 1152
    group = StackedGroup(p)
    for kind, elems in (("broadcast", 1 << 18), ("reduce", 1 << 18),
                        ("allreduce", 1 << 18), ("reduce_scatter", 1 << 18),
                        ("allgather", 512), ("allgatherv", 512)):
        x, kw, buffers = _comm_case(gen, kind, p, elems)
        plan = get_comm(group).plan(kind, x, **kw)
        before = dict(bp.LAUNCHES)
        got = tree_flatten(plan(x))[0]
        assert _launched(before) == comm_launches(plan, buffers), kind
        want = tree_flatten(get_comm(group, backend="torch").plan(kind, x, **kw)(x))[0]
        assert all(_same_bits(g.contiguous(), w.contiguous())
                   for g, w in zip(got, want)), kind
        if plan.kind in ("allgather", "allgatherv"):
            # every rank's copy equals the first, bit for bit
            for c, g in zip(tree_flatten(plan.per_rank(x))[0], got):
                assert c.shape == (p,) + g.shape, kind
                assert _same_bits(c.contiguous(),
                                  g.expand_as(c).contiguous()), kind
                del c
        del got, want
        torch.cuda.empty_cache()


OVERLAP_KINDS = ["broadcast", "reduce", "reduce_max", "allgather", "reduce_scatter"]
#: p and about the elements a rank; p = 1152 with narrow blocks.
OVERLAP_SIZES = [(2, 300), (5, 300), (64, 300), (1152, 24)]


@pytest.mark.parametrize("kind", OVERLAP_KINDS)
@pytest.mark.parametrize("p,elems", OVERLAP_SIZES)
def test_comm_overlap_equals_sequential_on_two_streams(gen, kind, p, elems):
    """The overlapped plan, its rolls on the group's side stream, equals
    the sequential plan bit for bit in each of 20 repeats, with the
    sequential plan's launch counts."""
    op = "max" if kind == "reduce_max" else "sum"
    kind = "reduce" if kind == "reduce_max" else kind
    x, kw, buffers = _comm_case(gen, kind, p, elems)
    if kind == "reduce":
        kw["op"] = op
    group = StackedGroup(p)
    want = tree_flatten(get_comm(group).plan(kind, x, **kw)(x))[0]
    plan = get_comm(group).plan(kind, x, overlap=True, **kw)
    side = group.side_stream()
    assert side is not None and side != torch.cuda.current_stream()
    for _ in range(20):
        before = dict(bp.LAUNCHES)
        got = tree_flatten(plan(x))[0]
        assert _launched(before) == comm_launches(plan, buffers)
        assert all(_same_bits(g.contiguous(), w.contiguous()) for g, w in zip(got, want))
        del got


@pytest.mark.parametrize("kind", ["broadcast", "reduce", "reduce_max", "allgather"])
@pytest.mark.parametrize("p,n,bs", [(2, 3, 50), (5, 4, 64), (64, 6, 33), (1152, 8, 4)])
def test_host_plan_overlap_equals_sequential_on_two_streams(gen, kind, p, n, bs):
    """host_plan: the overlapped run, its rolls on the host plans' side
    stream, equals the sequential run bit for bit in each of 20 repeats."""
    op = "max" if kind == "reduce_max" else "sum"
    kind = "reduce" if kind == "reduce_max" else kind
    shape = (n, bs) if kind == "broadcast" else (p, n, bs)
    values = torch.randn(shape, generator=gen, device="cuda")
    want = host_plan(kind, p, n, root=p // 3, op=op).run(values).clone()
    plan = host_plan(kind, p, n, root=p // 3, op=op, overlap=True)
    for _ in range(20):
        assert _same_bits(plan.run(values), want)


def test_streamed_step_on_the_side_stream_repeats_bit_for_bit(gen, monkeypatch):
    """A streamed compressed step of qwen2-smoke over StackedGroup(2), its
    bucket syncs on the side stream: three steps from one state leave the
    same state and loss, bit for bit, and the same as the step with the
    syncs run inline on the autograd stream."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import compression as tcomp
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = get_config("qwen2-0.5b", smoke=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    tcfg = TrainConfig(grad_sync="compressed", stream_grad_sync=True, microbatches=2)
    group = StackedGroup(2)
    step = make_train_step(cfg, tcfg, group=group)

    def one_step():
        state = init_train_state(cfg, tcfg, torch.Generator("cuda").manual_seed(0),
                                 group=group)
        state, m = step(state, data.batch_at(0))
        return [m["loss"]] + tree_flatten(state)[0]

    runs = [one_step() for _ in range(3)]
    assert tcomp._sync_stream(group, torch.device("cuda")) is not None
    monkeypatch.setattr(tcomp, "_sync_stream", lambda group, device: None)
    runs.append(one_step())
    for run in runs[1:]:
        assert all(_same_bits(a, b) for a, b in zip(runs[0], run))


def test_broadcast_state_on_the_card(gen):
    p = 37
    state = {"w": torch.randn((p, 64, 3), generator=gen, device="cuda").to(torch.bfloat16),
             "b": torch.randn((p, 64), generator=gen, device="cuda"),
             "step": torch.arange(p, dtype=torch.int32, device="cuda")}
    before = dict(bp.LAUNCHES)
    out = broadcast_state(StackedGroup(p), state, root=5)
    assert _launched(before)["block_unpack"] == 3      # one message a dtype
    for k, v in state.items():
        assert torch.equal(out[k], v[5].expand_as(v))


# ------------------------------------ the quantized wire and the trainer


def quantized_launches(plan, leaves):
    """One call of a quantized_allreduce plan: a leaf takes R + 1
    qacc_shuffles, then the broadcast of its int8 payload and its scales
    (two buffers: a pack, R - 1 shuffles and an unpack each)."""
    R = plan.statics[0].ks.shape[0]
    out = {"block_qacc_shuffle": (R + 1) * leaves, "block_pack": 2 * leaves,
           "block_shuffle": 2 * (R - 1) * leaves, "block_unpack": 2 * leaves}
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("p,root", [(2, 1), (5, 0), (37, 11)])
def test_comm_quantized_cuda_matches_torch(gen, p, root):
    """The communicator's quantized_allreduce of a 3-leaf pytree (a NaN
    lane, ragged leaves, 12 decades of magnitude), two error-feedback
    steps: "cuda" equals "torch" (NaN lanes by position), every rank's
    sums the same, the kernels launched as the rounds say."""
    def leaves():
        x = {"w": torch.randn((p, 300), generator=gen, device="cuda")
             * 10.0 ** torch.randint(-6, 6, (p, 1), generator=gen, device="cuda").float(),
             "b": torch.randn((p, 7, 3), generator=gen, device="cuda"),
             "z": torch.zeros((p, 40), device="cuda")}
        x["w"][p - 1, 17] = float("nan")
        return x

    x = leaves()
    plan = get_comm(StackedGroup(p)).plan("quantized_allreduce", x, root=root, qblock=8)
    plain = get_comm(StackedGroup(p), backend="torch").plan(
        "quantized_allreduce", x, root=root, qblock=8)
    for _ in range(2):
        before = dict(bp.LAUNCHES)
        sums, errs = plan(x)
        assert _launched(before) == quantized_launches(plan, 3)
        psums, perrs = plain(x)
        for k in x:
            assert sums[k].is_cuda and _same_or_nan(sums[k], psums[k])
            assert _same_or_nan(errs[k], perrs[k]) and torch.isfinite(errs[k]).all()
            assert all(_same_or_nan(sums[k][r], sums[k][0]) for r in range(p))
        x = {k: v + errs[k] for k, v in leaves().items()}


def test_compressed_grad_sync_cuda_matches_torch(gen):
    """compressed_grad_sync of a bf16/f32 gradient tree in several buckets
    at p = 4, two error-feedback steps: "cuda" equals "torch" bit for bit."""
    from repro_torch.optim import compression as comp

    p = 4
    like = {"emb": torch.zeros(64, 24, dtype=torch.bfloat16), "ln": torch.zeros(24),
            "pos0": {"w": torch.zeros(3, 24, 24), "b": torch.zeros(3, 24)}}
    spec = comp.make_bucket_spec(like, 4 * 1200)
    errs = {be: comp.init_grad_sync_state(spec, p) for be in ("cuda", "torch")}
    for _ in range(2):
        g = {"emb": torch.randn((p, 64, 24), generator=gen, device="cuda").to(torch.bfloat16),
             "ln": torch.randn((p, 24), generator=gen, device="cuda"),
             "pos0": {"w": torch.randn((p, 3, 24, 24), generator=gen, device="cuda"),
                      "b": torch.randn((p, 3, 24), generator=gen, device="cuda")}}
        out = {}
        for be in ("cuda", "torch"):
            out[be], errs[be] = comp.compressed_grad_sync(g, errs[be], StackedGroup(p),
                                                          spec, backend=be)
        for a, b in zip(tree_flatten(out["cuda"])[0], tree_flatten(out["torch"])[0]):
            assert a.is_cuda and _same_bits(a, b)
        for a, b in zip(errs["cuda"], errs["torch"]):
            assert _same_bits(a, b)


def test_model_kernels_refuse_grad_on_the_card(gen):
    """The kernels have no backward: under grad mode an operand that
    requires grad is refused before any launch; under no_grad they run."""
    q = torch.randn((1, 64, 4, 32), generator=gen, device="cuda", requires_grad=True)
    k = torch.randn((1, 64, 2, 32), generator=gen, device="cuda")
    x = torch.randn((1, 64, 4, 16), generator=gen, device="cuda", requires_grad=True)
    B_ = torch.randn((1, 64, 1, 8), generator=gen, device="cuda")
    dt = torch.rand((1, 64, 4), generator=gen, device="cuda")
    A, D = torch.zeros(4, device="cuda"), torch.ones(4, device="cuda")
    before = dict(fa.LAUNCHES), dict(ss.LAUNCHES)
    with pytest.raises(ValueError, match="flash_attention has no backward"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="ssd_scan has no backward"):
        ss.ssd_scan(x, B_, B_, dt, A, D, chunk=32)
    assert (dict(fa.LAUNCHES), dict(ss.LAUNCHES)) == before
    with torch.no_grad():
        fa.flash_attention(q, k, k)
        ss.ssd_scan(x, B_, B_, dt, A, D, chunk=32)
    assert fa.LAUNCHES["flash_attention"] == before[0]["flash_attention"] + 1
    assert ss.LAUNCHES["ssd_scan"] == before[1]["ssd_scan"] + 1


def test_train_step_sync_backends_agree_on_the_card(gen):
    """Two compressed steps of qwen2-smoke over StackedGroup(2), streamed
    and not: the "cuda" sync (the round-step kernels) leaves the same
    parameters and errors as the "torch" one, bit for bit."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = get_config("qwen2-0.5b", smoke=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    for stream in (False, True):
        states = {}
        for be in ("cuda", "torch"):
            tcfg = TrainConfig(grad_sync="compressed", grad_sync_backend=be,
                               stream_grad_sync=stream, microbatches=2)
            state = init_train_state(cfg, tcfg, torch.Generator("cuda").manual_seed(0),
                                     group=StackedGroup(2))
            step = make_train_step(cfg, tcfg, group=StackedGroup(2))
            before = dict(bp.LAUNCHES)
            for i in range(2):
                state, m = step(state, data.batch_at(i))
                assert torch.isfinite(m["loss"])
            launched = _launched(before)
            assert (launched.get("block_qacc_shuffle", 0) > 0) == (be == "cuda")
            states[be] = state
        for a, b in zip(tree_flatten(states["cuda"])[0], tree_flatten(states["torch"])[0]):
            assert _same_bits(a, b)


def test_checkpoint_round_trip_on_the_card(gen, tmp_path):
    """A compressed train state on the card (bf16 parameters, f32 moments,
    an int32 step, [2, bucket] error buckets) saved and restored into a
    template on the card: every leaf on the card, its dtype, bit-equal."""
    from repro_torch.train import CheckpointManager, TrainConfig, init_train_state

    cfg = get_config("qwen2-0.5b", smoke=True)
    tcfg = TrainConfig(grad_sync="compressed")
    state = init_train_state(cfg, tcfg, torch.Generator("cuda").manual_seed(0),
                             group=StackedGroup(2))
    for e in state["gsync_err"]:
        e.normal_(generator=gen)
    state["opt"]["step"].fill_(7)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, extra={"data_step": 7})
    mgr.wait()
    template = init_train_state(cfg, tcfg, torch.Generator("cuda").manual_seed(1),
                                group=StackedGroup(2))
    step, back, extra = mgr.restore_latest(template)
    assert (step, extra) == (7, {"data_step": 7})
    a, b = tree_flatten(state)[0], tree_flatten(back)[0]
    assert any(x.dtype == torch.bfloat16 for x in a)
    for x, y in zip(a, b):
        assert y.is_cuda and y.dtype == x.dtype and _same_bits(x, y)


def test_train_launcher_resumes_on_the_card(tmp_path, capsys):
    """``launch.train.main`` at --smoke on the card (its default device):
    4 compressed steps over 2 stacked ranks, then a resume to 6, which
    gives the 6-step run's state bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import train as launch

    args = ["--smoke", "--mesh", "2x1", "--grad-sync", "compressed", "--ckpt-every", "4"]
    first = launch.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    assert first["device"] == torch.cuda.get_device_name(0)
    second = launch.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "done: 2 steps" in out
    straight = launch.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b")])
    assert second["losses"] == {k: v for k, v in straight["losses"].items() if k > 4}
    for x, y in zip(tree_flatten(second["state"])[0], tree_flatten(straight["state"])[0]):
        assert x.is_cuda and _same_bits(x, y)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_memory_train_step_cuda_matches_cpu(gen, arch):
    """A compressed step of the vlm and encdec SMOKE configs in f32 over
    StackedGroup(2) on the card, against the same step on the CPU (the
    same weights, gates 0.5, batch and memory_embeds): losses within
    1e-3 x max(1, loss_0), the round-step kernels launched."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    T = cfg.n_image_tokens if cfg.family == "vlm" else cfg.n_audio_frames
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                                  memory_tokens=T, d_model=cfg.d_model))
    tcfg = TrainConfig(grad_sync="compressed", microbatches=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for layer in getattr(params, "layers", []):
        if hasattr(layer, "gate"):
            layer.gate.data.fill_(0.5)
    losses = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(params).to(dev)
        group = StackedGroup(2, device=dev)
        state = init_train_state(cfg, tcfg, params=model, group=group)
        step = make_train_step(cfg, tcfg, group=group)
        before = dict(bp.LAUNCHES)
        losses[dev] = []
        for i in range(2):
            state, m = step(state, data.batch_at(i))
            losses[dev].append(float(m["loss"]))
        assert (_launched(before).get("block_qacc_shuffle", 0) > 0) == (dev == "cuda")
    assert all(np.isfinite(losses["cuda"]))
    gap = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    assert gap <= 1e-3 * max(1.0, losses["cpu"][0]), losses


# ------------------------------------------------- the kernels' audit records
#
# repro_torch.analysis.kernelaudit replays each round-step kernel's record
# (kernels/block_pack.py KERNEL_AUDITS) on the CPU; these hold the records
# to the compiled kernels: the elements a launch changes are the record's
# write set, and the launch grid the record names is the launcher's.

from repro_torch.analysis import kernelaudit as ka  # noqa: E402


@pytest.mark.parametrize("name", list(bp.KERNEL_AUDITS))
def test_write_set_probe_matches_records(gen, name):
    """Every geometry of the kernel (each grid shape it has, at 16-byte
    and narrower units) over every launch of the p = 5, n = 4 schedule;
    then the negative control, a record with one write dropped, caught by
    the comparison of what the kernel changed (the plain version's is
    skipped)."""
    rep = ka.probe_kernels("cuda", names=[name], ps=(5,), ns=(4,))
    assert rep.ok and rep.checked > 0, rep.summary()
    bad = ka.probe_kernels("cuda", names=[name], ps=(5,), ns=(4,),
                           geometries={name: ka.GEOMETRIES[name][:1]},
                           specs={name: ka.dropped_write(bp.KERNEL_AUDITS[name])},
                           sides=("kernel",))
    assert bad.findings and all(
        f.check == "write-set" and f.message.startswith("the kernel ")
        for f in bad.findings), bad.summary()


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("name", list(bp.KERNEL_AUDITS))
def test_compiled_launch_grid_matches_record(gen, name, off):
    """The shape block_pack_launch_shape reports equals the record's at
    every geometry, with aligned operands and with every operand one
    element past an allocation's start (narrower units)."""
    for geom in ka.GEOMETRIES[name]:
        ops = ka._operands(name, 7, 5, geom, "cuda", gen)
        ops = {k: _offset(v, off) for k, v in ops.items()}
        ka._sentinels(name, ops, gen, "sum")
        before = {k: v.clone() for k, v in ops.items()}
        compiled = bp.compiled_launch_shape(name, ops)
        want = bp.KERNEL_AUDITS[name].shape(
            **{**bp.shape_args(name, ops), "resident": compiled.resident})
        assert compiled == want, (geom, compiled, want)
        torch.cuda.synchronize()
        # a dry run launches nothing: every operand is as it was
        assert all(torch.equal(ops[k], before[k]) for k in ops)


def test_analysis_cli_on_the_card(gen, tmp_path):
    from repro_torch.analysis.__main__ import main

    bench = tmp_path / "bench.json"
    assert main(["--all", "--bench", str(bench)]) == 0
    import json

    passes = json.loads(bench.read_text())["passes"]
    assert all(p["checked"] > 0 and p["findings"] == 0 for p in passes.values())


def test_cuda_operands_never_reach_the_plain_version(gen, monkeypatch):
    """Every wrapper launches its kernel on a CUDA operand, counted, with
    its plain version unreachable (a meta operand, the dry run's, runs the
    plain version and loads nothing: ``tests/test_torch_dryrun.py``)."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA operand reached a plain version")

    for name in dir(ref):
        if name.endswith("_ref"):
            monkeypatch.setattr(ref, name, refuse)
    monkeypatch.setattr(fa, "blocked_attention", refuse)
    monkeypatch.setattr(ss, "ssd_chunked", refuse)
    bp.reset_launches()
    fa.reset_launches()
    ss.reset_launches()
    buf, msg, recv, send = _operands(gen, (8, 5, 64), torch.float32)
    bp.block_pack(buf, send)
    bp.block_unpack(buf, msg, recv)
    bp.block_shuffle(buf, msg, recv, send)
    bp.block_shuffle_staged(buf, msg, msg.clone(), recv, send)
    bp.block_acc_shuffle(buf, msg, recv, send)
    bp.block_acc_shuffle_staged(buf, msg, msg.clone(), recv, send)
    qbuf = torch.randn((8, 5, 256), generator=gen, device="cuda")
    err = torch.zeros_like(qbuf)
    qmsg = torch.zeros((8, 256), dtype=torch.int8, device="cuda")
    bp.block_qacc_shuffle(qbuf, err, qmsg, torch.ones((8, 1), device="cuda"), recv, send)
    q = torch.randn((1, 64, 4, 32), generator=gen, device="cuda", dtype=torch.bfloat16)
    fa.flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    x = torch.randn((1, 64, 4, 16), generator=gen, device="cuda")
    bc = torch.randn((1, 64, 1, 16), generator=gen, device="cuda")
    ss.ssd_scan(x, bc, bc.clone(), torch.rand((1, 64, 4), generator=gen, device="cuda"),
                torch.zeros(4, device="cuda"), torch.ones(4, device="cuda"), chunk=32)
    torch.cuda.synchronize()
    assert all(v == 1 for v in bp.LAUNCHES.values()), bp.LAUNCHES
    assert fa.LAUNCHES["flash_attention"] == 1 and ss.LAUNCHES["ssd_scan"] == 1
