"""Reduction op registry shared by every data-plane layer of the port.

Port of ``repro.kernels.reduce_ops``.  The kernels' drain identity, the
plain versions' combine and the host plans' identity slot must agree
bit for bit (the reduce family re-ships drained slots in capped rounds,
so the identity must be absorbing under the combine).  This module is
the single source for the plain side; ``csrc/block_pack.cu`` writes the
same combine and identities out per element type.
"""

from __future__ import annotations

import torch

OPS = ("sum", "+", "max")


def _validate(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"unsupported reduction op {op!r} (use 'sum' or 'max')")


def _max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's ``max``, bit for bit where it is defined by value.

    ``torch.maximum`` already propagates NaN, but it returns -0 for
    max(-0, +0) where XLA (``jnp.maximum``, the reference's combine)
    returns +0 in either order.  So, on top of it: equal operands give
    ``a`` unless ``a`` carries the sign bit (then ``b``: +0 wins over
    -0, and equal nonzero values have equal bits); a NaN operand is
    returned itself, ``b``'s first, as XLA on the CPU returns it, so
    which NaN comes out does not rest on how ``torch.maximum`` picks.
    The CUDA kernel makes the same choices, so the two agree bit for bit
    on the card.
    """
    m = torch.maximum(a, b)
    if not a.is_floating_point():
        return m
    m = torch.where(a == b, torch.where(torch.signbit(a), b, a), m)
    m = torch.where(torch.isnan(a), a, m)
    return torch.where(torch.isnan(b), b, m)


def op_combine(op: str):
    """The binary combine of ``op`` on tensors.

    ``sum`` is ``torch.add``: one correctly rounded add in the operands'
    own dtype (bf16 and f16 add in f32 and round once; integer sums wrap
    in two's complement, as the reference's do).  Denormals are kept, as
    IEEE and torch's CUDA ops keep them; XLA on the CPU flushes them, the
    one deliberate difference from the reference.  ``max`` is
    :func:`_max`.
    """
    _validate(op)
    return torch.add if op in ("sum", "+") else _max


def op_identity(op: str, dtype: torch.dtype):
    """Scalar identity of ``op`` in ``dtype`` (drained slots hold it), as
    a Python number: 0 for sum; -inf / the integer minimum for max."""
    _validate(op)
    if op in ("sum", "+"):
        return 0
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min
