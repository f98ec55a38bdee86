"""Carry the reference's parameters and decode caches across to the port.

The reference keeps parameters as a pytree of arrays with each pattern
position's layers stacked over R (``params["pos{i}"]``); the port keeps
``R * len(pattern)`` layer modules in execution order.  These functions
take that pytree with its leaves as NumPy arrays (``np.asarray`` of each
JAX array; bfloat16 arrives as the ``ml_dtypes`` type) and fill the
port's :class:`~repro_torch.models.transformer.Model` with the same
numbers, every dtype kept.  The tests use them to run both
implementations from one set of weights and one cache state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.comm import resolve_device
from .common import ModelConfig
from .transformer import Model, init_params, layer_pattern


def to_tensor(a, device) -> torch.Tensor:
    """A NumPy array (bfloat16 from ``ml_dtypes`` included) as a tensor on
    ``device`` with the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _leaf(tree: Dict[str, Any], path):
    for key in path:
        tree = tree[key]
    return tree


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None) -> Model:
    """The port's model holding the reference's ``init_params`` pytree
    ``tree`` (NumPy leaves).  Raises if a parameter is missing, left over,
    or differs in shape or dtype."""
    model = init_params(cfg, device=device)
    k = len(layer_pattern(cfg)[0])
    used = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            r, i = divmod(int(parts[1]), k)
            path = (f"pos{i}", *parts[2:])
            value = to_tensor(_leaf(tree, path)[r], p.device)
        else:
            path = tuple(parts)
            value = to_tensor(_leaf(tree, path), p.device)
        if value.shape != p.shape or value.dtype != p.dtype:
            raise ValueError(f"{name}: reference {tuple(value.shape)} {value.dtype}, "
                             f"port {tuple(p.shape)} {p.dtype}")
        p.data.copy_(value)
        used.add(path)
    leaves = set()

    def walk(node, path):
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, (*path, key))
        else:
            leaves.add(path)

    walk(tree, ())
    if leaves != used:
        raise ValueError(f"reference parameters not carried across: "
                         f"{sorted(leaves - used)}")
    return model


def cache_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """The reference's ``init_cache`` pytree (NumPy leaves, stacked
    [R, B, ...] as the port's) as the port's cache dict on ``device``."""
    dev = resolve_device(device)
    return {key: to_tensor(value, dev) for key, value in tree.items()}
