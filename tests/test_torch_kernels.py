"""The port's round-step kernels (plain versions, and the wrappers on
CPU tensors, which take them) against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode
(``repro.kernels.block_pack``), on the same numpy inputs from a seed.

Tolerance: exact, compared bit for bit -- the copy kernels only move
data, and the accumulating ones make one correctly rounded add (or XLA's
max) in the buffer's dtype, as the reference does.  Float inputs are
standard normal, so no sum is a denormal: XLA on the CPU flushes
denormals to zero where the port keeps IEEE denormals, the one
deliberate difference, pinned by its own test below.
64-bit dtypes run on the JAX side inside a scoped
``jax.enable_x64(True)``, never the global flag.  bfloat16 goes to JAX
as ``ml_dtypes.bfloat16`` and to the port as a ``uint16`` view turned
into ``torch.bfloat16``.
"""

import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.kernels.block_pack as jbp
import repro.kernels.ref as jref
from repro_torch.kernels import block_pack as bp
from repro_torch.kernels import ref

DTYPES = ["float32", "int32", "bfloat16", "float64", "int64"]
SHAPES = [(1, 4, 8), (8, 6, 16), (17, 9, 131)]
#: Short rows, as the CUDA kernels' short-row path takes them: the
#: allgather's and the reduce_scatter's (8 KiB a rank, p = 1152: 44 slots
#: of 48 float32, 192-byte rows) at 40 rows, and rows of 5 elements (5
#: bytes in int8, copied a byte at a time on the card; accumulated an
#: element at a time in every dtype).
SHORT_SHAPES = [(40, 44, 48), (24, 6, 5)]
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _np(rng, shape, dtype):
    if dtype == "bfloat16":
        return rng.standard_normal(shape, dtype=np.float32).astype(ml_dtypes.bfloat16)
    if dtype.startswith("int"):
        return rng.integers(-1000, 1000, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    bits = _BITS[a.element_size()]
    return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))


def _x64(dtype):
    return jax.enable_x64(True) if dtype.endswith("64") else contextlib.nullcontext()


def _inputs(dtype, shape, seed):
    R, ns, bs = shape
    rng = np.random.default_rng(seed)
    buf, msg = _np(rng, shape, dtype), _np(rng, (R, bs), dtype)
    recv = rng.integers(0, ns, size=R).astype(np.int32)
    send = rng.integers(0, ns, size=R).astype(np.int32)
    send[0] = recv[0]          # the pipeline case: forward what just arrived
    return buf, msg, recv, send


@pytest.mark.parametrize("shape", SHAPES + SHORT_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES + ["int8"])
def test_pack_matches_jax(dtype, shape):
    buf, _, _, send = _inputs(dtype, shape, 1)
    with _x64(dtype):
        want = [jref.block_pack_ref(jnp.asarray(buf), jnp.asarray(send)),
                jbp.block_pack(jnp.asarray(buf), jnp.asarray(send), interpret=True)]
        want = [_torch(w) for w in want]
    for got in (ref.block_pack_ref(_torch(buf), _torch(send)),
                bp.block_pack(_torch(buf), _torch(send))):
        for w in want:
            assert _same_bits(got, w)


@pytest.mark.parametrize("shape", SHAPES + SHORT_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES + ["int8"])
def test_unpack_matches_jax(dtype, shape):
    buf, msg, recv, _ = _inputs(dtype, shape, 2)
    with _x64(dtype):
        args = (jnp.asarray(buf), jnp.asarray(msg), jnp.asarray(recv))
        want = [_torch(jref.block_unpack_ref(*args)),
                _torch(jbp.block_unpack(*args, interpret=True))]
    for fn in (ref.block_unpack_ref, bp.block_unpack):
        tbuf = _torch(buf)
        got = fn(tbuf, _torch(msg), _torch(recv))
        assert got is tbuf                       # updated in place
        for w in want:
            assert _same_bits(got, w)


@pytest.mark.parametrize("shape", SHAPES + SHORT_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES + ["int8"])
def test_shuffle_matches_jax(dtype, shape):
    buf, msg, recv, send = _inputs(dtype, shape, 3)
    with _x64(dtype):
        args = (jnp.asarray(buf), jnp.asarray(msg), jnp.asarray(recv),
                jnp.asarray(send))
        want = [tuple(map(_torch, jref.block_shuffle_ref(*args))),
                tuple(map(_torch, jbp.block_shuffle(*args, interpret=True)))]
    for fn in (ref.block_shuffle_ref, bp.block_shuffle):
        tbuf = _torch(buf)
        got_buf, got_msg = fn(tbuf, _torch(msg), _torch(recv), _torch(send))
        assert got_buf is tbuf
        for wb, wm in want:
            assert _same_bits(got_buf, wb) and _same_bits(got_msg, wm)


@pytest.mark.parametrize("shape", SHAPES + SHORT_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES + ["int8"])
def test_shuffle_staged_matches_jax(dtype, shape):
    buf, msg, recv, send = _inputs(dtype, shape, 6)
    pre = np.take_along_axis(buf, send[:, None, None], axis=1)[:, 0]
    with _x64(dtype):
        args = (jnp.asarray(buf), jnp.asarray(msg), jnp.asarray(pre),
                jnp.asarray(recv), jnp.asarray(send))
        want = [tuple(map(_torch, jref.block_shuffle_staged_ref(*args)))]
        if shape == SHAPES[1] or shape in SHORT_SHAPES:
            want.append(tuple(map(_torch, jbp.block_shuffle_staged(
                *args, interpret=True))))
    for fn in (ref.block_shuffle_staged_ref, bp.block_shuffle_staged):
        tbuf = _torch(buf)
        got_buf, got_msg = fn(tbuf, _torch(msg), _torch(pre), _torch(recv),
                              _torch(send))
        assert got_buf is tbuf
        for wb, wm in want:
            assert _same_bits(got_buf, wb) and _same_bits(got_msg, wm)


def _acc_cases(op, dtype, shape, seed):
    buf, msg, acc, fwd = _inputs(dtype, shape, seed)
    pre = np.take_along_axis(buf, fwd[:, None, None], axis=1)[:, 0]
    return buf, msg, pre, acc, fwd


def _check_acc_shuffles(op, dtype, buf, msg, pre, acc, fwd, pallas):
    with _x64(dtype):
        seq = (jnp.asarray(buf), jnp.asarray(msg), jnp.asarray(acc),
               jnp.asarray(fwd))
        stg = (jnp.asarray(buf), jnp.asarray(msg), jnp.asarray(pre),
               jnp.asarray(acc), jnp.asarray(fwd))
        want = [tuple(map(_torch, jref.block_acc_shuffle_ref(*seq, op=op))),
                tuple(map(_torch, jref.block_acc_shuffle_staged_ref(*stg, op=op)))]
        if pallas:
            want.append(tuple(map(_torch, jbp.block_acc_shuffle(
                *seq, op=op, interpret=True))))
            want.append(tuple(map(_torch, jbp.block_acc_shuffle_staged(
                *stg, op=op, interpret=True))))
    a, m, p_, ai, fi = map(_torch, (buf, msg, pre, acc, fwd))
    got = []
    for fn, args in ((ref.block_acc_shuffle_ref, (m, ai, fi)),
                     (bp.block_acc_shuffle, (m, ai, fi)),
                     (ref.block_acc_shuffle_staged_ref, (m, p_, ai, fi)),
                     (bp.block_acc_shuffle_staged, (m, p_, ai, fi))):
        tbuf = a.clone()
        res = fn(tbuf, *args, op=op)
        assert res[0] is tbuf
        got.append(res)
    for gb, gm in got:
        for wb, wm in want:
            assert _same_bits(gb, wb) and _same_bits(gm, wm)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("shape", SHAPES + SHORT_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_acc_shuffles_match_jax(dtype, shape, op):
    case = _acc_cases(op, dtype, shape, 7)
    _check_acc_shuffles(op, dtype, *case,
                        pallas=shape == SHAPES[1] or shape in SHORT_SHAPES)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_acc_shuffles_pin_max_signed_zero_and_nan(dtype):
    # acc slot a, message m: every (a, m) pair of NaN, +-0 and numbers;
    # XLA's max gives +0 for (-0, +0) in either order and keeps NaN.
    pairs = [(np.nan, 1.0), (1.0, np.nan), (-0.0, 0.0), (0.0, -0.0),
             (-0.0, -0.0), (np.nan, -np.nan), (-np.inf, -0.0), (2.0, 3.0)]
    R, ns = len(pairs), 3
    buf = np.random.default_rng(8).standard_normal((R, ns, 4)).astype(dtype)
    msg = np.zeros((R, 4), dtype)
    acc = np.zeros(R, np.int32)
    fwd = np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int32)     # some coincide
    for r, (x, y) in enumerate(pairs):
        buf[r, 0], msg[r] = x, y
    pre = np.take_along_axis(buf, fwd[:, None, None], axis=1)[:, 0]
    _check_acc_shuffles("max", dtype, buf, msg, pre, acc, fwd, pallas=True)
    # A sum of two NaNs keeps one of them, which one is the hardware's
    # choice and no part of the contract: the sum case keeps one NaN.
    msg[5] = 1.0
    _check_acc_shuffles("sum", dtype, buf, msg, pre, acc, fwd, pallas=True)


def test_denormal_sum_keeps_ieee_where_xla_flushes():
    # The one deliberate difference from the reference: XLA on the CPU
    # flushes f32 denormals to zero; the port (like torch's CUDA ops, and
    # the CUDA kernel, built without -ftz) keeps them.
    tiny = np.float32(1e-45)                    # the least f32 denormal
    buf = np.full((1, 2, 1), tiny, np.float32)
    msg = np.full((1, 1), tiny, np.float32)
    acc, fwd = np.zeros(1, np.int32), np.ones(1, np.int32)
    jb, _ = jref.block_acc_shuffle_ref(jnp.asarray(buf), jnp.asarray(msg),
                                       jnp.asarray(acc), jnp.asarray(fwd))
    assert np.asarray(jb)[0, 0, 0] == 0.0
    for fn in (ref.block_acc_shuffle_ref, bp.block_acc_shuffle):
        tb, _ = fn(_torch(buf), _torch(msg), _torch(acc), _torch(fwd))
        assert tb[0, 0, 0].view(torch.int32) == 2     # 2 * 2^-149, exact


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool, torch.complex64])
def test_acc_wrappers_reject_dtypes_without_a_kernel(dtype):
    buf = torch.zeros((4, 3, 5), dtype=dtype)
    msg = torch.zeros((4, 5), dtype=dtype)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        bp.block_acc_shuffle(buf, msg, idx, idx)
    with pytest.raises(TypeError):
        bp.block_acc_shuffle_staged(buf, msg, msg, idx, idx)


def test_acc_wrappers_reject_unknown_ops():
    buf, msg, recv, send = map(_torch, _inputs("float32", (8, 6, 16), 9))
    with pytest.raises(ValueError):
        bp.block_acc_shuffle(buf, msg, recv, send, op="min")


def test_cpu_wrappers_launch_nothing():
    before = dict(bp.LAUNCHES)
    buf, msg, recv, send = map(_torch, _inputs("float32", (8, 6, 16), 4))
    bp.block_pack(buf, send)
    bp.block_unpack(buf, msg, recv)
    bp.block_shuffle(buf, msg, recv, send)
    bp.block_shuffle_staged(buf, msg, msg.clone(), recv, send)
    bp.block_acc_shuffle(buf, msg, recv, send, op="max")
    bp.block_acc_shuffle_staged(buf, msg, msg.clone(), recv, send)
    assert bp.LAUNCHES == before


@pytest.mark.parametrize("fault", ["idx_int64", "idx_shape", "msg_dtype",
                                   "msg_shape", "noncontiguous", "buf_2d",
                                   "meta_device"])
def test_wrappers_reject_bad_operands(fault):
    buf, msg, recv, send = map(_torch, _inputs("float32", (8, 6, 16), 5))
    if fault == "idx_int64":
        recv = recv.long()
    elif fault == "idx_shape":
        recv = recv[:4]
    elif fault == "msg_dtype":
        msg = msg.double()
    elif fault == "msg_shape":
        msg = msg[:, :8]
    elif fault == "noncontiguous":
        msg = msg.t().contiguous().t()
    elif fault == "buf_2d":
        buf = buf[:, 0]
    else:
        buf, msg, recv, send = (t.to("meta") for t in (buf, msg, recv, send))
    with pytest.raises((ValueError, TypeError)):
        bp.block_shuffle(buf, msg, recv, send)
