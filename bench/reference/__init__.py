"""The plain reference: one file a collective kind, ``<collective>.py``,
found by the name the mix gives.  Each has

* ``compare(x, out, t) -> {number: value}``: what every rank must hold
  after one call on the input ``x`` (the payload the harness made: one
  tensor, or a dict of them), against the program's result ``out``; the
  names are those of the mix's ``checks``;
* ``control(x, t, dtype)``: the reference put in the program's place,
  computed in ``dtype``, the precision below the configuration's, which
  the comparison has to find wrong.

``t`` is the cell's traffic (``bench/harness/traffic.py``: ``p``,
``root``, ``entry``, ``sizes``).  Plain PyTorch; nothing here imports the
program.  Rows are worked in blocks, so that the reference fits beside
the program's outputs on the card.  The helpers below are shared by the
kinds' files.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

BLOCK_BYTES = 1 << 30
#: The control's precision: the nearest below each stated one.
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16,
         torch.bfloat16: torch.float8_e4m3fn, torch.float16: torch.float8_e4m3fn}


def lower(dtype: torch.dtype) -> torch.dtype:
    """The precision the control computes in, for a stated ``dtype``."""
    if dtype not in LOWER:
        raise ValueError(f"no precision below {dtype} for a control")
    return LOWER[dtype]


def leaves(tree) -> Optional[List[Tuple[Optional[str], torch.Tensor]]]:
    """``[(name, tensor)]`` of a payload or result: one tensor, or a dict
    of them by name (None for anything else)."""
    if isinstance(tree, torch.Tensor):
        return [(None, tree)]
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor) for v in tree.values()):
        return sorted(tree.items())
    return None


def map_leaves(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """``tree`` with ``fn`` applied to each leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: fn(v) for k, v in tree.items()}


def worst(gaps) -> float:
    """The largest gap, NaN where any is NaN, inf where there is none."""
    gaps = list(gaps)
    if any(math.isnan(g) for g in gaps):
        return math.nan
    return max(gaps, default=math.inf)


def per_leaf(x, out, gap: Callable[[torch.Tensor, torch.Tensor], float]) -> float:
    """The widest ``gap(input leaf, result leaf)`` over the leaves; inf
    where the result's leaves are not the input's."""
    xs, outs = leaves(x), leaves(out)
    if xs is None or outs is None or [k for k, _ in xs] != [k for k, _ in outs]:
        return math.inf
    return worst(gap(a, b) for (_, a), (_, b) in zip(xs, outs))


def rows_per_block(row_elems: int) -> int:
    return max(1, BLOCK_BYTES // (8 * max(1, row_elems)))


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference, in float64; NaN or inf where
    either side is not finite."""
    if got.numel() == 0:
        return 0.0
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def rows_gap(rows: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between each of ``rows`` (along the first axis) and
    ``want``, a block of rows at a time."""
    step = rows_per_block(want.numel())
    return worst(gap(rows[a:a + step], want) for a in range(0, rows.shape[0], step))


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """The float64 sum of ``x``'s rows, a block of rows at a time."""
    total = torch.zeros(x.shape[1:], dtype=torch.float64, device=x.device)
    step = rows_per_block(x[0].numel())
    for a in range(0, x.shape[0], step):
        total += x[a:a + step].to(torch.float64).sum(0)
    return total
