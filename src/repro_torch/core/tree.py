"""Pytrees in ``jax.tree``'s order.

The payloads of the communicator and the trees of gradient compression
are nests of dicts, lists, tuples and namedtuples over tensors.  The
reference flattens them with ``jax.tree.flatten``, and the order of the
leaves is part of its results: a leaf's index in an error text,
``allgatherv``'s ``sizes`` trees and the per-dtype packing of the
restore broadcast all follow it.  ``torch.utils._pytree`` keeps a dict's
insertion order where JAX sorts its keys, so this module flattens by
JAX's rules:

  * a plain dict (and a ``defaultdict``) in sorted key order, an
    ``OrderedDict`` in its own order;
  * lists, tuples and namedtuples in order;
  * ``None`` is an empty node, not a leaf;
  * anything else is a leaf.

A :class:`TreeDef` is hashable and prints as JAX's ``PyTreeDef`` does.
:func:`tree_flatten_with_path` gives each leaf its key path in the same
order, of :class:`DictKey`, :class:`SequenceKey` and :class:`GetAttrKey`
entries that print as ``jax.tree_util``'s; :func:`path_key` renders a
path as the checkpoint's ``"a/b/0"``.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["TreeDef", "tree_flatten", "tree_unflatten", "tree_structure",
           "tree_leaves", "DictKey", "SequenceKey", "GetAttrKey",
           "tree_flatten_with_path", "path_key"]

_LEAF = "*"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


@dataclass(frozen=True)
class TreeDef:
    """The structure of a pytree: nested tuples, ``"*"`` for a leaf.

    A node is ``("none",)``, ``("dict", keys, children)``,
    ``("odict", keys, children)``, ``("ddict", factory, keys,
    children)``, ``("list", children)``, ``("tuple", children)`` or
    ``("ntuple", cls, children)``."""

    node: Any

    @property
    def num_leaves(self) -> int:
        return _count(self.node)

    def __str__(self) -> str:
        return f"PyTreeDef({_render(self.node)})"

    __repr__ = __str__


def _count(node) -> int:
    if node == _LEAF:
        return 1
    return sum(_count(c) for c in node[-1]) if node[0] != "none" else 0


def _render(node) -> str:
    if node == _LEAF:
        return "*"
    kind = node[0]
    if kind == "none":
        return "None"
    kids = [_render(c) for c in node[-1]]
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(node[1], kids)) + "}"
    if kind == "list":
        return "[" + ", ".join(kids) + "]"
    if kind == "tuple":
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    if kind == "ntuple":
        head = f"namedtuple[{node[1].__name__}]"
    elif kind == "odict":
        head = f"OrderedDict[{node[1]!r}]"
    else:
        head = f"defaultdict[({node[1]!r}, {node[2]!r})]"
    return f"CustomNode({head}, [{', '.join(kids)}])"


def _flatten(x, leaves: list, is_leaf):
    if is_leaf is not None and is_leaf(x):
        leaves.append(x)
        return _LEAF
    if x is None:
        return ("none",)
    if isinstance(x, OrderedDict):
        keys = tuple(x)
        return ("odict", keys, tuple(_flatten(x[k], leaves, is_leaf) for k in keys))
    if isinstance(x, defaultdict):
        keys = tuple(sorted(x))
        return ("ddict", x.default_factory, keys,
                tuple(_flatten(x[k], leaves, is_leaf) for k in keys))
    if type(x) is dict:
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_flatten(x[k], leaves, is_leaf) for k in keys))
    if _is_namedtuple(x):
        return ("ntuple", type(x), tuple(_flatten(v, leaves, is_leaf) for v in x))
    if type(x) in (list, tuple):
        return (type(x).__name__, tuple(_flatten(v, leaves, is_leaf) for v in x))
    leaves.append(x)
    return _LEAF


def tree_flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s order; ``is_leaf``
    stops the descent where it returns True, as JAX's does."""
    leaves: list = []
    node = _flatten(tree, leaves, is_leaf)
    return leaves, TreeDef(node)


def tree_structure(tree, is_leaf=None) -> TreeDef:
    return tree_flatten(tree, is_leaf)[1]


def tree_leaves(tree, is_leaf=None) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def _build(node, it):
    if node == _LEAF:
        return next(it)
    kind = node[0]
    if kind == "none":
        return None
    kids = [_build(c, it) for c in node[-1]]
    if kind == "dict":
        return dict(zip(node[1], kids))
    if kind == "odict":
        return OrderedDict(zip(node[1], kids))
    if kind == "ddict":
        return defaultdict(node[1], zip(node[2], kids))
    if kind == "ntuple":
        return node[1](*kids)
    return list(kids) if kind == "list" else tuple(kids)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """Inverse of :func:`tree_flatten` (a plain dict comes back with its
    keys sorted, as JAX rebuilds it)."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{treedef} takes {treedef.num_leaves} leaves, "
                         f"got {len(leaves)}")
    return _build(treedef.node, iter(leaves))


@dataclass(frozen=True)
class DictKey:
    """A dict (or ``OrderedDict``, ``defaultdict``) key on a key path."""

    key: Any

    def __str__(self) -> str:
        return f"[{self.key!r}]"


@dataclass(frozen=True)
class SequenceKey:
    """A list or tuple index on a key path."""

    idx: int

    def __str__(self) -> str:
        return f"[{self.idx}]"


@dataclass(frozen=True)
class GetAttrKey:
    """A namedtuple field on a key path."""

    name: str

    def __str__(self) -> str:
        return f".{self.name}"


def _entries(node) -> list:
    """The key entries of a node's children, in flatten order."""
    kind = node[0]
    if kind in ("dict", "odict"):
        return [DictKey(k) for k in node[1]]
    if kind == "ddict":
        return [DictKey(k) for k in node[2]]
    if kind == "ntuple":
        return [GetAttrKey(f) for f in node[1]._fields]
    return [SequenceKey(i) for i in range(len(node[-1]))]


def _paths(node, prefix: tuple, out: list) -> None:
    if node == _LEAF:
        out.append(prefix)
    elif node[0] != "none":
        for entry, child in zip(_entries(node), node[-1]):
            _paths(child, prefix + (entry,), out)


def tree_flatten_with_path(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                           ) -> Tuple[List[Tuple[tuple, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in :func:`tree_flatten`'s order,
    as ``jax.tree_util.tree_flatten_with_path``: a path is a tuple of key
    entries from the root to the leaf."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    paths: list = []
    _paths(treedef.node, (), paths)
    return list(zip(paths, leaves)), treedef


def path_key(path) -> str:
    """A key path as the checkpoint names its array: each dict key as
    ``str(key)``, each index as ``str(i)`` (a namedtuple field by its
    name), joined by ``/``."""
    return "/".join(str(k.key) if isinstance(k, DictKey) else
                    str(k.idx) if isinstance(k, SequenceKey) else k.name
                    for k in path)
