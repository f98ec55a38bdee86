"""Mesh descriptors for the sharding rules and the training launcher.

Port of ``repro.launch.mesh``.  One card has no device mesh, so a
:class:`Mesh` here is a plain descriptor: the axis sizes and their names,
with ``.shape`` the ``{axis: size}`` mapping that a JAX ``Mesh`` gives.
The sharding rules (:mod:`repro_torch.train.sharding`) read nothing else
of it, and the launcher runs its data-parallel extent as the rows of one
:class:`~repro_torch.core.comm.StackedGroup`.  ``set_global_mesh`` has no
counterpart: there is no ambient mesh to set.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence, Tuple

__all__ = ["Mesh", "make_production_mesh", "make_host_mesh"]


@dataclass(frozen=True, init=False)
class Mesh:
    """``Mesh(shape, axis_names)``: ``shape`` the axis sizes, in order."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        sizes, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(sizes) != len(names):
            raise ValueError(f"mesh shape {sizes} does not match axes {names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh shape {sizes} has an axis under 1")
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh(p: int, axis: str = "data") -> Mesh:
    """A one-axis mesh of ``p`` ranks."""
    return Mesh((p,), (axis,))
