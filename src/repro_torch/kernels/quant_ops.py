"""Shared int8 block-quantization math of the quantized data plane.

Port of ``repro.kernels.quant_ops``.  One source of the quantize,
dequantize and error arithmetic for the layers that must agree bit for
bit: the plain round step (:func:`repro_torch.kernels.ref.block_qacc_shuffle_ref`),
the root's final requantization in the host plan, and
``repro_torch.optim.compression``.  ``csrc/block_pack.cu`` writes the
same arithmetic out with intrinsics.

Scheme: per-block symmetric int8.  A [nb, qb] f32 tile quantizes to
(q int8 [nb, qb], scale f32 [nb, 1]) with scale = amax * INV127 floored
at ``SCALE_FLOOR`` and q = clip(round_half_even(x / scale), +-127).  A
block holding any non-finite value keeps its finite lanes quantized
against the finite amax and gets a NaN scale (the per-block flag): it
dequantizes to all-NaN, and its error lanes are exactly 0.

Rounding: the reference runs this math under ``jax.jit``, and XLA
contracts ``cur + q*s`` (the accumulate) and ``x - q*s`` (the error
capture) into fused multiply-adds, one rounding each -- the
``optimization_barrier`` in ``dequant_blocks`` does not stop it.  Eager
JAX rounds the product first and so differs on many lanes.  The port
follows the jitted form on purpose and spells it out:
:func:`fma_f32` is the correctly rounded f32 value of ``a + q*s``.
"""

from __future__ import annotations

import numpy as np
import torch

QBLOCK = 256
SCALE_FLOOR = 1e-12
#: The f32 reciprocal of 127, multiplied (never divided) into amax, as
#: the reference writes it.
INV127 = float(np.float32(1.0) / np.float32(127.0))

__all__ = [
    "QBLOCK",
    "SCALE_FLOOR",
    "INV127",
    "fma_f32",
    "quant_blocks",
    "dequant_blocks",
    "quant_error",
    "block_nonfinite",
]


def fma_f32(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            sign: int = 1) -> torch.Tensor:
    """The f32 fused multiply-add ``a + sign*q*s``, rounded once.

    ``a`` and ``s`` are f32, ``q`` int8 (or f32 holding integers of at
    most 8 bits); they broadcast.  In f64 the product of an 8-bit and a
    24-bit significand is exact, but the f64 add may round, and the
    cast to f32 would round again.  So the f64 sum is made round-to-odd
    (TwoSum gives the add's error; where it is nonzero and the sum's
    last bit is even, step one ulp toward the error), after which the
    cast to f32 rounds correctly (53 >= 24 + 2 bits).  Non-finite sums
    pass through unchanged.
    """
    a64 = a.double()
    prod = q.double() * s.double()
    if sign < 0:
        prod = -prod
    total = a64 + prod
    # TwoSum: res = (a64 + prod) - total exactly.
    bv = total - a64
    av = total - bv
    res = (a64 - av) + (prod - bv)
    even = (total.view(torch.int64) & 1) == 0
    nudge = (res != 0) & even & torch.isfinite(total)
    toward = torch.where(res > 0, float("inf"), float("-inf")).to(total.dtype)
    total = torch.where(nudge, torch.nextafter(total, toward), total)
    return total.float()


def quant_blocks(x2d: torch.Tensor):
    """Quantize a [nb, qb] f32 tile -> (q int8 [nb, qb], scale f32 [nb, 1]).

    The scale of any block holding a non-finite entry is NaN; its finite
    lanes are still quantized against the finite amax.
    """
    x2d = x2d.float()
    finite = torch.isfinite(x2d)
    xf = torch.where(finite, x2d, torch.zeros((), dtype=torch.float32,
                                              device=x2d.device))
    amax = xf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(amax * INV127, SCALE_FLOOR)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    all_finite = finite.all(dim=1, keepdim=True)
    scale = torch.where(all_finite, scale,
                        torch.full((), float("nan"), device=x2d.device))
    return q, scale


def dequant_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize [nb, qb] int8 against [nb, 1] scales -> [nb, qb] f32
    (one rounded product; flagged blocks come out all-NaN)."""
    return q.float() * scale


def quant_error(x2d: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Elementwise quantization error ``x - q*scale``, fused (one
    rounding, as the jitted reference), with non-finite lanes set to 0
    so error feedback is never poisoned."""
    err = fma_f32(x2d, q, scale, -1)
    return torch.where(torch.isfinite(err), err, torch.zeros_like(err))


def block_nonfinite(scale: torch.Tensor) -> torch.Tensor:
    """Per-block nonfinite flag surfaced from a quantized scale vector."""
    return ~torch.isfinite(scale)
