"""Checkpoint-restore fan-out through the paper's n-block circulant
broadcast.

Port of ``repro.train.restore_broadcast``.  At fleet scale one host
reads the checkpoint; the state must then reach every data-parallel
replica.  :func:`broadcast_state` does that with the plan/execute
communicator (:mod:`repro_torch.core.comm`): leaves are packed per dtype
into one flat message each, so a round makes one exchange per distinct
dtype (typically 1-3), not one per leaf, and the whole state rides one
schedule with the alpha-beta-optimal n blocks, in n-1+ceil(log2 p)
rounds.  Leaves keep their dtypes, and restores of the same state spec
reuse one cached plan.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.comm import get_comm
from ..core.costmodel import CommModel, optimal_num_blocks_bcast
from ..core.engine import get_bundle
from ..core.tree import tree_flatten, tree_unflatten

__all__ = ["restore_plan", "broadcast_state"]

#: A data-centre network: 2 us latency, 25 GB/s.
DCN_MODEL = CommModel(alpha=2e-6, beta=1.0 / 25e9)


def restore_plan(p: int, nbytes: int, *, root: int = 0,
                 model: CommModel = DCN_MODEL,
                 n_blocks: Optional[int] = None):
    """Host-side plan of a restore fan-out -> ``(bundle, n, rounds)``.

    Computes the alpha-beta-optimal block count for the checkpoint size
    and warms the process-wide schedule cache for ``(p, root)``: on an
    elastic restore (p changed since the last run) this is the only
    schedule work, before any device code runs.
    """
    bundle = get_bundle(p, root)
    n = n_blocks or max(1, optimal_num_blocks_bcast(p, nbytes, model))
    return bundle, n, bundle.rounds(n)


def broadcast_state(group: Any, state: Any, *, root: int = 0,
                    model: CommModel = DCN_MODEL,
                    n_blocks: Optional[int] = None,
                    backend: str = "cuda") -> Any:
    """Broadcast a state pytree from ``root``'s slice over ``group``.

    Every leaf carries a leading per-rank axis (its rows of the group:
    p of them on a :class:`~repro_torch.core.comm.StackedGroup`, one on a
    :class:`~repro_torch.core.comm.DistGroup`), only the root's content
    meaningful.  Returns the tree with every slice equal to the root's.
    Leaves are concatenated per dtype into one flat ``[rows, total]``
    message each, so a round costs ``#dtypes * alpha`` rather than
    ``#leaves * alpha``, and every leaf comes back in its own dtype.
    """
    rows = len(group.ranks)
    leaves, treedef = tree_flatten(state)
    groups: dict = {}                       # dtype name -> leaf indices
    for i, leaf in enumerate(leaves):
        if leaf.shape[0] != rows:
            raise ValueError(f"leaf {i} has leading axis {leaf.shape[0]}, "
                             f"the group holds {rows} ranks here")
        groups.setdefault(str(leaf.dtype).removeprefix("torch."), []).append(i)
    packed = {key: torch.cat([leaves[i].reshape(rows, -1) for i in idxs], dim=1)
              for key, idxs in groups.items()}
    comm = get_comm(group, backend=backend, model=model)
    out = comm.broadcast(packed, n_blocks=n_blocks, root=root)
    outs: list = [None] * len(leaves)
    for key, idxs in groups.items():
        off = 0
        for i in idxs:
            size = leaves[i][0].numel()
            outs[i] = out[key][:, off: off + size].reshape(leaves[i].shape)
            off += size
    return tree_unflatten(treedef, outs)
