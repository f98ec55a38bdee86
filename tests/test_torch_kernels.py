"""The port's round-step kernels (plain versions, and the wrappers on
CPU tensors, which take them) against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode
(``repro.kernels.block_pack``), on the same numpy inputs from a seed.

Tolerance: exact, compared bit for bit -- the kernels only move data.
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
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
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


def test_cpu_wrappers_launch_nothing():
    before = dict(bp.LAUNCHES)
    buf, msg, recv, send = map(_torch, _inputs("float32", (8, 6, 16), 4))
    bp.block_pack(buf, send)
    bp.block_unpack(buf, msg, recv)
    bp.block_shuffle(buf, msg, recv, send)
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
