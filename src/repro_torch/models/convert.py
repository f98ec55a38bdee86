"""Carry parameters between the reference's stacked layout and the port's
per-layer modules.

The reference keeps parameters as a pytree of arrays with each pattern
position's layers stacked over R (``params["pos{i}"]``) and the
encoder's over its depth (``params["enc"]``); the port keeps
``R * len(pattern)`` layer modules in execution order (``layers.N``) and
the encoder's in a list of its own (``enc.N``).  The other blocks (the
hybrid family's ``shared_attn``, deepseek-v3's ``mtp`` and
``mtp_proj``) are one leaf each in both, not stacked.
:func:`params_from_jax` and :func:`cache_from_jax` take the reference's
pytree with its leaves as NumPy arrays (``np.asarray`` of each JAX array;
bfloat16 arrives as the ``ml_dtypes`` type) and fill the port's
:class:`~repro_torch.models.transformer.Model` (or cache) with the same
numbers, every dtype kept.

:func:`stack_layers` lays per-layer tensors named like the model's
parameters (the parameters themselves, their gradients or optimizer
moments) out as the reference's stacked tree, :func:`unstack_layers`
gives back views of a stacked tree's leaves by parameter name, and
:func:`bind` makes a model that computes with given tensors in place of
its parameters.  The trainer keeps its state in the stacked layout, so
its gradient buckets, weight decay and moments follow the reference's
leaves.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

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
        path, r = _stacked_path(name, k)
        leaf = _leaf(tree, path)
        value = to_tensor(leaf if r is None else leaf[r], p.device)
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


def _stacked_path(name: str, k: int):
    """A parameter name -> (its path in the reference's tree, its index in
    the stacked leaf -- the layer's repeat r, or the encoder layer --, or
    None for a leaf that is not stacked)."""
    parts = name.split(".")
    if parts[0] == "layers":
        r, i = divmod(int(parts[1]), k)
        return (f"pos{i}", *parts[2:]), r
    if parts[0] == "enc":
        return ("enc", *parts[2:]), int(parts[1])
    return tuple(parts), None


def stack_layers(model: Model, cfg: ModelConfig,
                 tensors: Optional[Mapping[str, torch.Tensor]] = None, *,
                 dim: int = 0) -> Dict[str, Any]:
    """The reference's stacked tree of ``tensors`` (name -> tensor, named
    and shaped like ``model``'s parameters, after ``dim`` leading axes;
    default: the parameters themselves, detached): each pattern position's
    R layers stacked along ``dim`` under ``pos{i}``, the other leaves as
    they are (not copied)."""
    k = len(layer_pattern(cfg)[0])
    if tensors is None:
        tensors = {n: p.detach() for n, p in model.named_parameters()}
    groups: Dict[tuple, list] = {}
    for name, _ in model.named_parameters():
        path, r = _stacked_path(name, k)
        groups.setdefault(path, []).append((r, tensors[name]))
    tree: Dict[str, Any] = {}
    for path, items in groups.items():
        if items[0][0] is None:
            leaf = items[0][1]
        else:
            leaf = torch.stack([t for _, t in sorted(items, key=lambda it: it[0])],
                               dim=dim)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def unstack_layers(model: Model, cfg: ModelConfig, tree: Dict[str, Any], *,
                   dim: int = 0) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`stack_layers`: name -> tensor, each a view of
    the stacked tree's leaf (one ``unbind`` a leaf, so a gradient flows
    back into the stacked leaf in one copy)."""
    k = len(layer_pattern(cfg)[0])
    out, views = {}, {}
    for name, _ in model.named_parameters():
        path, r = _stacked_path(name, k)
        leaf = _leaf(tree, path)
        if r is None:
            out[name] = leaf
            continue
        if path not in views:
            views[path] = leaf.unbind(dim)
        out[name] = views[path][r]
    return out


def bind(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> nn.Module:
    """A shallow copy of ``model`` whose parameters are ``tensors`` (name
    -> tensor, every parameter named): the model's functions compute with
    them, and autograd flows into them.  ``model`` is not changed (it may
    be a ``meta`` model that holds shapes only)."""
    used = set()

    def rebind(module, prefix):
        clone = copy.copy(module)
        params = {}
        for key, value in module._parameters.items():
            name = prefix + key
            if value is not None:
                if name not in tensors:
                    raise ValueError(f"no tensor for parameter {name}")
                if tuple(tensors[name].shape) != tuple(value.shape):
                    raise ValueError(f"{name}: tensor {tuple(tensors[name].shape)}, "
                                     f"parameter {tuple(value.shape)}")
                value = tensors[name]
                used.add(name)
            params[key] = value
        clone.__dict__["_parameters"] = params
        clone.__dict__["_modules"] = {
            key: None if sub is None else rebind(sub, f"{prefix}{key}.")
            for key, sub in module._modules.items()}
        return clone

    out = rebind(model, "")
    extra = set(tensors) - used
    if extra:
        raise ValueError(f"tensors for no parameter: {sorted(extra)}")
    return out
