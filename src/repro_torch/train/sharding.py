"""Parameter / batch / cache PartitionSpec rules for the production mesh.

Port of ``repro.train.sharding``, rule for rule.  Mesh axes: ('data',
'model') single-pod or ('pod', 'data', 'model') multi-pod.  Batch shards
over (pod, data); parameters are 2-D sharded: the "model" (TP/EP)
dimension over 'model' and the FSDP dimension over (pod, data) -- ZeRO-3
style.

Rules are name-based on the last path component with MoE-expert special
cases; stacked (scanned) parameters get a leading None axis.  Paths come
from :func:`~repro_torch.core.tree.tree_flatten_with_path`, so a spec tree
has its params tree's structure.  One card places nothing: the specs are
what a multi-device run would lay out, and ``named`` has no counterpart.
The rules read a mesh's axis names and sizes only, so any mesh will do:
:class:`repro_torch.launch.mesh.Mesh` or a JAX one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Protocol, Tuple

from ..core.tree import DictKey, tree_flatten_with_path, tree_unflatten

__all__ = ["PartitionSpec", "P", "mesh_axes", "set_ep_mode", "ep_axes",
           "fit_spec", "param_pspecs", "batch_pspecs", "set_cache_seq_shard",
           "cache_pspecs"]


def _entry(axis):
    """One dimension's axes as ``jax.sharding.PartitionSpec`` keeps them:
    a one-name tuple is that name, an empty tuple is None."""
    if isinstance(axis, list):
        axis = tuple(axis)
    if isinstance(axis, tuple):
        if not axis:
            return None
        if len(axis) == 1:
            return axis[0]
    return axis


class PartitionSpec(tuple):
    """A tuple with one entry a dimension: an axis name, a tuple of axis
    names, or None (replicated).  ``P("data", None)``."""

    def __new__(cls, *partitions):
        return super().__new__(cls, (_entry(a) for a in partitions))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshLike(Protocol):
    """What the rules read of a mesh."""

    @property
    def axis_names(self) -> Tuple[str, ...]: ...

    @property
    def shape(self) -> Mapping[str, int]: ...


def mesh_axes(mesh: MeshLike) -> Tuple[Tuple[str, ...], str]:
    """Returns (dp_axes, model_axis) for a production mesh."""
    names = mesh.axis_names
    model = "model" if "model" in names else names[-1]
    dp = tuple(n for n in names if n != model)
    return dp, model


# base-ndim rules: name -> (base_ndim, spec)
def _rules(dp, model):
    fs = dp if (isinstance(dp, tuple) and len(dp) > 1) else (
        dp[0] if dp else None)
    return {
        # [in, out] column-parallel
        "wq": (2, P(fs, model)),
        "wk": (2, P(fs, model)),
        "wv": (2, P(fs, model)),
        "w_gate": (2, P(fs, model)),
        "w_up": (2, P(fs, model)),
        "w_in": (2, P(fs, model)),
        "in_proj": (2, P(fs, model)),
        "w_dq": (2, P(fs, model)),
        "w_uq": (2, P(fs, model)),
        "w_dkv": (2, P(fs, None)),
        "w_uk": (2, P(None, model)),
        "w_uv": (2, P(None, model)),
        "w_kr": (2, P(fs, None)),
        "img_proj": (2, P(fs, model)),
        "mtp_proj": (2, P(fs, model)),
        # [in, out] row-parallel
        "wo": (2, P(model, fs)),
        "w_down": (2, P(model, fs)),
        "w_out": (2, P(model, fs)),
        "out_proj": (2, P(model, fs)),
        # embeddings: vocab over model, d over fsdp
        "embed": (2, P(model, fs)),
        "unembed": (2, P(model, fs)),
        # biases follow the sharded output dim
        "bq": (1, P(model)),
        "bk": (1, P(model)),
        "bv": (1, P(model)),
        # ssm conv
        "conv_w": (2, P(None, model)),
        "conv_b": (1, P(model)),
        # router: small, replicated
        "router": (2, P(None, None)),
    }


EP_MODE = "2d"  # "2d": E over model + FFN dim over fsdp (ZeRO-3 style)
                # "full": E over (data x model) -- experts fully local,
                # dispatch becomes an all-to-all (the DeepSeek-V3 EP design)


def set_ep_mode(mode: str):
    global EP_MODE
    assert mode in ("2d", "full")
    EP_MODE = mode


def ep_axes(mesh: MeshLike):
    """Expert-sharding axes under EP_MODE='full': (data, model) --
    'pod' (if present) shards the expert d dim instead (E=256 does not
    divide 512)."""
    return tuple(n for n in mesh.axis_names if n in ("data", "model"))


def _moe_expert_specs(dp, model, mesh: MeshLike):
    if EP_MODE == "full":
        ea = ep_axes(mesh)
        pod = "pod" if "pod" in mesh.axis_names else None
        return {
            "w_gate": P(ea, pod, None),
            "w_up": P(ea, pod, None),
            "w_down": P(ea, None, pod),
        }
    return {
        "w_gate": P(model, None, dp),
        "w_up": P(model, None, dp),
        "w_down": P(model, dp, None),
    }


def _path_names(path) -> Tuple[str, ...]:
    return tuple(str(k.key) if isinstance(k, DictKey) else str(k) for k in path)


def _axis_size(mesh: MeshLike, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def fit_spec(spec, shape, mesh: MeshLike) -> PartitionSpec:
    """Drop spec axes whose mesh size does not divide the dimension.

    Odd vocabularies (49155, 50280, 51865) and batch=1 cells would
    otherwise not divide; dropping the axis replicates that dim."""
    fitted = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            fitted.append(None if i >= len(shape) else ax)
            continue
        fitted.append(ax if shape[i] % _axis_size(mesh, ax) == 0 else None)
    return P(*fitted)


def _map_with_path(fn, tree):
    pairs, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [fn(path, leaf) for path, leaf in pairs])


def param_pspecs(cfg, params_shape: Any, mesh: MeshLike, no_fsdp: bool = False):
    """PartitionSpec tree matching a params (shape) tree.

    no_fsdp=True replicates parameters over the dp axes (inference: no
    optimizer state, so ZeRO-style dp-sharding only buys a per-step
    weight all-gather)."""
    dp, model = mesh_axes(mesh)
    fs = None if no_fsdp else (dp if len(dp) > 1 else (dp[0] if dp else None))
    rules = _rules(() if no_fsdp else dp, model)

    def spec_for(path, leaf):
        names = _path_names(path)
        name = names[-1]
        ndim = len(leaf.shape)
        in_moe = any("moe" in n for n in names) and not any(
            n == "shared" for n in names
        )
        moe_specs = _moe_expert_specs(fs, model, mesh)
        if in_moe and name in moe_specs and ndim >= 3:
            base = moe_specs[name]
            extra = ndim - 3
            return fit_spec(P(*([None] * extra + list(base))), leaf.shape, mesh)
        if name in rules:
            base_ndim, base = rules[name]
            extra = ndim - base_ndim
            if extra < 0:
                return P()
            return fit_spec(P(*([None] * extra + list(base))), leaf.shape, mesh)
        return P()  # norms, scalars, A_log, D, dt_bias, gate ...

    return _map_with_path(spec_for, params_shape)


def batch_pspecs(cfg, mesh: MeshLike, batch_shape: Dict[str, Any]):
    dp, model = mesh_axes(mesh)
    fs = dp if len(dp) > 1 else dp[0]
    out = {}
    for k, v in batch_shape.items():
        nd = len(v.shape)
        out[k] = fit_spec(P(*([fs] + [None] * (nd - 1))), v.shape, mesh)
    return out


CACHE_SEQ_SHARD = True  # False: batch-only sharding (replicate S over
                        # model) when kv heads don't divide the axis


def set_cache_seq_shard(flag: bool):
    global CACHE_SEQ_SHARD
    CACHE_SEQ_SHARD = flag


def cache_pspecs(cfg, mesh: MeshLike, cache_shape: Dict[str, Any]):
    """Decode-cache sharding: batch over dp where possible; the sequence
    dim of attention caches over 'model' when kv-heads don't divide the
    model axis (flash-decode style), else heads over 'model'."""
    dp, model = mesh_axes(mesh)
    fs = dp if len(dp) > 1 else dp[0]
    msize = mesh.shape[model]
    out = {}
    for k, v in cache_shape.items():
        nd = len(v.shape)
        if k == "pos_idx":
            out[k] = P(fs)  # per-slot positions, batch-sharded
        elif k == "memory":
            out[k] = P(fs, None, None)
        elif k.endswith("_k") or k.endswith("_v"):
            # [R, B, S, Hkv, hd]
            hkv = v.shape[3]
            if hkv % msize == 0:
                out[k] = P(None, fs, None, model, None)
            elif CACHE_SEQ_SHARD:
                out[k] = P(None, fs, model, None, None)
            else:
                out[k] = P(None, fs, None, None, None)
        elif k.endswith("_ckv") or k.endswith("_kr"):
            # [R, B, S, r] (MLA compressed cache): seq over model
            if CACHE_SEQ_SHARD:
                out[k] = P(None, fs, model, None)
            else:
                out[k] = P(None, fs, None, None)
        elif k.endswith("_conv"):
            out[k] = P(None, fs, None, model)
        elif k.endswith("_ssd"):
            # [R, B, H, N, P]: heads over model
            out[k] = P(None, fs, model, None, None)
        else:
            out[k] = P(*([None] * nd))
        out[k] = fit_spec(out[k], v.shape, mesh)
    return out
