"""Checked wrapper of the stacked exchange's row-rotation CUDA kernel.

The kernel (``csrc/row_roll.cu``, built by :mod:`repro_torch.kernels._build`
at the first launch) replaces ``torch.roll`` along dim 0 or 1 of a
contiguous tensor, for the port's exchange: :func:`repro_torch.core.comm._roll`
(``StackedGroup.exchange`` and ``start_exchange``, the host plans' rolls)
and ``core/hier.py``'s level rolls.  It ports no TPU kernel: there the
exchange was a collective permute between chips.

:func:`roll` checks device, contiguity and the dim, then

  * on CPU tensors runs ``torch.roll``;
  * on CUDA tensors allocates the output with ``torch.empty_like`` (as
    ``torch.roll`` does), launches the kernel on the current stream, adds
    one to :data:`LAUNCHES` under its path, and raises if the launch failed.

There is no fallback from a CUDA tensor to ``torch.roll``.  The tensor is
viewed as bytes ``[outer, A, inner]`` with ``A`` its size along ``dim``; each
outer index is one row of ``A * inner`` bytes rotated by ``(shift mod A) *
inner`` bytes, moved in units of the widest of 16, 8, 4, 2, 1 bytes that
divides ``inner`` and both addresses.  Path ``"vector16"`` is the 16-byte
one, ``"narrow"`` every other.

A roll is on the host's critical path wherever its messages are small (the
allgatherv's 65 rolls a round), so the launch is kept short: the C entry
point is bound once, the stream is passed as its raw handle, and the plan
is a few integer operations.
"""

from __future__ import annotations

import torch

from . import _build

#: Kernel launches since the last :func:`reset_launches`, by path: 16-byte
#: units (``"vector16"``) or narrower (``"narrow"``).  :func:`roll` adds one
#: where it launches the kernel, and nowhere else.
LAUNCHES = {"vector16": 0, "narrow": 0}

#: ``row_roll_launch`` of the loaded library, bound at the first launch.
_entry = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def roll(x: torch.Tensor, shift: int, dim: int = 0) -> torch.Tensor:
    """``torch.roll(x, shift, dims=dim)`` for a contiguous ``x`` and
    ``dim`` 0 or 1: ``out[.., (a + shift) % A, ..] = x[.., a, ..]``."""
    if dim not in (0, 1) or dim >= x.dim():
        raise ValueError(f"row_roll takes dim 0 or 1 of a tensor of at least "
                         f"dim + 1 axes, got dim {dim} of {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("row_roll takes a contiguous tensor")
    if x.is_cuda:
        return _kernel_roll(x, shift, dim)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return torch.roll(x, shift, dims=dim)


def _kernel_roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """The kernel's roll of a contiguous ``x`` (checked by :func:`roll`):
    the output, the launch's arguments, the launch and its count."""
    out = torch.empty_like(x)
    nbytes = x.nbytes
    if nbytes:
        A = x.size(dim)
        outer = x.size(0) if dim else 1
        row = nbytes // outer                        # A * inner bytes
        inner = row // A
        src, dst = x.data_ptr(), out.data_ptr()
        bits = inner | src | dst
        unit = 16 if bits & 15 == 0 else bits & -bits
        _launch(src, dst, outer, row, int(shift) % A * inner, unit,
                x.get_device())
        LAUNCHES["vector16" if unit == 16 else "narrow"] += 1
    return out


def _launch(src: int, dst: int, outer: int, row_bytes: int, split_bytes: int,
            unit: int, device: int) -> None:
    """``row_roll_launch`` on the current stream of CUDA device ``device``
    (an index); raises ``RuntimeError`` if it refused the launch."""
    global _entry
    if _entry is None:
        _entry = _build.load("row_roll").row_roll_launch
    err = _entry(src, dst, outer, row_bytes, split_bytes, unit, device,
                 torch._C._cuda_getCurrentRawStream(device))
    if err:
        msg = _build.load("row_roll").row_roll_error_string(err).decode()
        raise RuntimeError(f"row_roll failed: CUDA error {err} ({msg})")
