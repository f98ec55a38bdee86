"""The exchange's row rotation (``repro_torch.kernels.row_roll``) on the
CPU: the wrapper's launch, with the kernel's copy played on the host at
the addresses and with the arguments the wrapper passes, equals
``torch.roll`` byte for byte; the wrapper on CPU tensors is ``torch.roll``
and launches nothing.  The kernel itself is held against ``torch.roll``
on the card (``tests/test_torch_cuda.py``)."""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import row_roll

DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.int8]
#: (shape, dim): dim 0 (outer 1) and dim 1 of ``[outer, A, inner]``, inner
#: rows of 16 and 32 bytes and of sizes no multiple of 16 (in int8 or bf16
#: some odd), and empty tensors.
CASES = [((7, 4), 0), ((6, 8), 0), ((5, 3, 5), 0), ((36, 3), 0),
         ((3, 5, 4), 1), ((4, 6, 3, 2), 1), ((0, 4), 0), ((3, 0, 2), 1)]
SHIFTS = (0, 1, 3, -1, -4, 5, 13, -29)


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8)


def _tensor(shape, dtype, seed, off=0):
    """A contiguous tensor ``off`` elements past an allocation's start, so
    that its address is aligned to its element size only."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-100, 100, shape, generator=g).to(dtype)
    if not off:
        return x
    return torch.empty(x.numel() + off, dtype=dtype)[off:].view(shape).copy_(x)


def _host(addr, nbytes):
    return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(addr))


def _kernel_on_the_host(calls):
    """A stand-in for ``row_roll._launch``: the C entry point's checks,
    then csrc/row_roll.cu's copy, unit by unit, between the two host
    addresses: unit ``w`` of a row goes to ``w + split``, less the row
    where that passes its end."""
    def launch(src, dst, outer, row_bytes, split_bytes, unit, device):
        calls.append((src, dst, outer, row_bytes, split_bytes, unit))
        assert unit in (16, 8, 4, 2, 1)
        assert 0 <= split_bytes < row_bytes and outer > 0
        assert row_bytes % unit == 0 and split_bytes % unit == 0
        assert src % unit == 0 and dst % unit == 0
        n = outer * row_bytes
        inp = _host(src, n).reshape(outer, row_bytes // unit, unit)
        out = _host(dst, n).reshape(outer, row_bytes // unit, unit)
        row, split = row_bytes // unit, split_bytes // unit
        w = np.arange(row)
        d = w + split
        out[:, np.where(d < row, d, d - row)] = inp[:, w]
    return launch


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,dim", CASES, ids=str)
def test_kernel_launch_equals_torch_roll(shape, dim, dtype, monkeypatch):
    """Whatever the wrapper hands the kernel -- the row and split bytes,
    the unit, the two addresses -- copies to ``torch.roll``'s bytes: for
    shifts of either sign and past ``A``, aligned tensors and tensors one
    element off, one launch a non-empty roll, counted under its path."""
    calls = []
    monkeypatch.setattr(row_roll, "_launch", _kernel_on_the_host(calls))
    row_roll.reset_launches()
    launched = 0
    for off in (0, 1):
        x = _tensor(shape, dtype, len(shape) * 10 + dim, off)
        A, outer_ = shape[dim], shape[0] if dim else 1
        inner = x.numel() // max(1, outer_ * A) * x.element_size()
        for shift in SHIFTS:
            before = len(calls)
            got = row_roll._kernel_roll(x, shift, dim)
            assert got.shape == x.shape and got.dtype == dtype
            assert torch.equal(_bytes(got), _bytes(torch.roll(x, shift, dims=dim))), shift
            if x.numel() == 0:
                assert len(calls) == before
                continue
            assert len(calls) == before + 1
            src, dst, outer, row, split, unit = calls[-1]
            assert (src, dst) == (x.data_ptr(), got.data_ptr())
            assert outer == outer_ and row == A * inner
            assert split == shift % A * inner
            assert unit == max(u for u in (16, 8, 4, 2, 1)
                               if inner % u == 0 and src % u == 0 and dst % u == 0)
            launched += 1
    assert sum(row_roll.LAUNCHES.values()) == launched
    assert row_roll.LAUNCHES["vector16"] == sum(c[-1] == 16 for c in calls)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cpu_roll_is_torch_roll_and_launches_nothing(dtype):
    row_roll.reset_launches()
    x = _tensor((6, 5, 3), dtype, 1)
    for dim in (0, 1):
        for shift in SHIFTS:
            got = row_roll.roll(x, shift, dim)
            assert got.dtype == dtype and got.shape == x.shape
            assert torch.equal(_bytes(got), _bytes(torch.roll(x, shift, dims=dim)))
    assert row_roll.LAUNCHES == {"vector16": 0, "narrow": 0}
    with pytest.raises(ValueError, match="contiguous"):
        row_roll.roll(x.transpose(0, 1), 1)
    with pytest.raises(ValueError, match="dim 0 or 1"):
        row_roll.roll(x, 1, 2)
    with pytest.raises(ValueError, match="dim 0 or 1"):
        row_roll.roll(x[:, 0, 0], 1, 1)
