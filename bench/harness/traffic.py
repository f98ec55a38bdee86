"""The one generator of traffic: a mix file's parameters -> the payload each
call carries, made on the device from ``--seed``.

A mix (``traffic/<mix>.json``) gives:

* ``collective``: the collective kind a call runs (``broadcast``,
  ``allreduce``, ``allgather``, ...); its reference is
  ``reference/<collective>.py`` and its work ``work/<collective>.py``;
* ``entry``: ``call`` (``plan(payload)``) or ``per_rank``
  (``plan.per_rank(payload)``: every rank's copy of a gather);
* ``leaves``: the payload, one entry a leaf, each ``[p, elements]``:
  ``bytes_per_rank``; ``dtype`` (a torch dtype's name; the
  configuration's ``dtype`` where left out); ``values``: ``normal``
  (standard normal; floating dtypes) or ``integer`` (whole numbers in
  ``[-value_bound, value_bound]``, so that a sum in any order is exact);
  and a ``name`` each where there are two or more (the payload is then a
  dict of them, else the one tensor);
* ``sizes`` (optional): ``{"min": a, "max": b}``, the elements each rank
  contributes (an irregular gather): the same p sizes, spread evenly from
  a to b, for every seed, in an order drawn from the seed;
* ``plan`` (optional): further arguments of the plan (``op``,
  ``qblock``, ``overlap``, ``n_blocks``);
* ``checks``: each number the reference compares, with its limit.

Every mix runs as a closed loop of one caller.  Before call k the harness
writes k (folded into the value range for integer values) into the first
element of the first leaf's marker row, so that each call's result is its
own: the root's row for a broadcast (the only row whose input reaches the
result), row 0 otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

#: Collective kinds whose plan takes the configuration's ``root``.
ROOTED = ("broadcast", "reduce", "allreduce", "quantized_allreduce")
VALUES = ("normal", "integer")


@dataclass
class Leaf:
    name: Optional[str]
    dtype: torch.dtype
    elements: int               # a rank's elements
    values: str
    bound: int = 0              # integer values lie in [-bound, bound]

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def bytes_per_rank(self) -> int:
        return self.elements * self.itemsize


@dataclass
class Traffic:
    """One cell's traffic: the payload (``tensors`` by leaf, in the mix's
    order; ``payload`` as the program takes it) and what the plan, the
    reference and the work files read of it."""

    collective: str
    entry: str
    p: int
    root: int
    leaves: List[Leaf]
    tensors: List[torch.Tensor]
    sizes: Optional[List[int]] = None
    plan_kwargs: Dict[str, Any] = field(default_factory=dict)
    checks: Dict[str, float] = field(default_factory=dict)

    @property
    def payload(self) -> Any:
        if len(self.leaves) == 1 and self.leaves[0].name is None:
            return self.tensors[0]
        return {leaf.name: x for leaf, x in zip(self.leaves, self.tensors)}

    @property
    def device(self) -> torch.device:
        return self.tensors[0].device

    @property
    def marker_row(self) -> int:
        return self.root if self.collective == "broadcast" else 0

    def plan_args(self) -> Dict[str, Any]:
        """The keyword arguments of ``comm.plan(collective, payload, ...)``."""
        kw = dict(self.plan_kwargs)
        if self.collective in ROOTED:
            kw["root"] = self.root
        if self.sizes is not None:
            kw["sizes"] = list(self.sizes)
        return kw

    def free(self) -> None:
        """Drop the payload, keep what the metrics read."""
        self.tensors = []


def dtype_named(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def ranks(config: Dict[str, Any]) -> int:
    """The configuration's rank count: ``p``, or ``nodes * cores``."""
    if "p" in config:
        return int(config["p"])
    return int(config["nodes"]) * int(config["cores"])


def leaves_of(config: Dict[str, Any], mix: Dict[str, Any]) -> List[Leaf]:
    specs = mix["leaves"]
    if not specs:
        raise ValueError("a mix needs at least one leaf")
    if len(specs) > 1 and len({s.get("name") for s in specs}) != len(specs):
        raise ValueError("two or more leaves need a name each, all different")
    out = []
    for s in specs:
        dtype = dtype_named(s.get("dtype", config["dtype"]))
        leaf = Leaf(name=s.get("name") if len(specs) > 1 else None, dtype=dtype,
                    elements=0, values=s["values"], bound=int(s.get("value_bound", 0)))
        nbytes = int(s["bytes_per_rank"])
        if nbytes % leaf.itemsize:
            raise ValueError(f"bytes_per_rank {nbytes} is not a whole number "
                             f"of {dtype} elements")
        leaf.elements = nbytes // leaf.itemsize
        if leaf.values not in VALUES:
            raise ValueError(f"unknown values {leaf.values!r} (have {VALUES})")
        if leaf.values == "normal" and not dtype.is_floating_point:
            raise ValueError(f"normal values need a floating dtype, not {dtype}")
        if leaf.values == "integer" and leaf.bound < 1:
            raise ValueError("integer values need a value_bound of 1 or more")
        out.append(leaf)
    return out


def sizes_of(mix: Dict[str, Any], p: int, leaves: List[Leaf], seed: int):
    """The p sizes of an irregular mix, the same set for every seed, in an
    order drawn from it (None for a regular mix)."""
    spec = mix.get("sizes")
    if spec is None:
        return None
    lo, hi = int(spec["min"]), int(spec["max"])
    if not 1 <= lo <= hi or any(hi > leaf.elements for leaf in leaves):
        raise ValueError(f"sizes [{lo}, {hi}] must lie in [1, elements]")
    even = np.rint(np.linspace(lo, hi, p)).astype(np.int64)
    order = np.random.default_rng(int(seed)).permutation(p)
    return [int(s) for s in even[order]]


def make(config: Dict[str, Any], mix: Dict[str, Any], device: torch.device,
         seed: int) -> Traffic:
    """The cell's traffic, its payload filled from ``seed``."""
    p = ranks(config)
    leaves = leaves_of(config, mix)
    if mix["entry"] not in ("call", "per_rank"):
        raise ValueError(f"unknown entry {mix['entry']!r}")
    if not mix.get("checks"):
        raise ValueError("a mix names the numbers compared and their limits "
                         "under 'checks'")
    t = Traffic(collective=mix["collective"], entry=mix["entry"], p=p,
                root=int(config.get("root", 0)) if mix["collective"] in ROOTED else 0,
                leaves=leaves,
                tensors=[torch.empty((p, leaf.elements), dtype=leaf.dtype, device=device)
                         for leaf in leaves],
                sizes=sizes_of(mix, p, leaves, seed),
                plan_kwargs=dict(mix.get("plan", {})),
                checks={k: float(v) for k, v in mix["checks"].items()})
    return fill(t, seed)


def fill(t: Traffic, seed: int) -> Traffic:
    """Fill every leaf in place from ``seed``, with one generator on the
    payload's device: one call a leaf."""
    g = torch.Generator(device=t.device)
    g.manual_seed(int(seed) % (1 << 63))
    for leaf, x in zip(t.leaves, t.tensors):
        if leaf.values == "normal":
            x.normal_(generator=g)
        else:
            x.random_(-leaf.bound, leaf.bound + 1, generator=g)
    return t


def marker(leaf: Leaf, k: int) -> float:
    """The value written for call ``k``: k itself for normal values, k
    folded into the value range for integer ones."""
    if leaf.values == "integer":
        return float(k % (2 * leaf.bound + 1) - leaf.bound)
    return float(k)


def write_marker(t: Traffic, k: int) -> None:
    """Write call ``k``'s marker: a fill on the device (a Python number
    assigned to an element would go through a blocking host copy)."""
    t.tensors[0][t.marker_row, :1].fill_(marker(t.leaves[0], k))
