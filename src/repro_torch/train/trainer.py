"""Training step factory: microbatching, remat, AdamW, gradient compression.

Port of ``repro.train.trainer``.  ``make_train_step`` returns a
``(state, batch) -> (state, metrics)`` function that updates ``state`` in
place:

  * the state keeps the parameters, the AdamW moments and the gradients
    in the reference's stacked layout (``pos{i}`` leaves stacked over the
    R repeats, :mod:`repro_torch.models.convert`), so the gradient
    buckets, the weight decay "on matrices only" and the moments follow
    the reference's leaves; the model the loss runs through is a ``meta``
    model bound to views of those leaves;
  * microbatching: the batch is split into ``microbatches`` slices, their
    gradients accumulated in ``grad_acc_dtype``;
  * remat: ``"none"`` | ``"full"`` | ``"dots"`` checkpointing of each
    super-block;
  * ``grad_sync="auto"``: one backward over the global batch (the
    reference's GSPMD reduction, exact); the group is not used;
  * ``grad_sync="compressed"`` over a group of p > 1 ranks
    (:class:`~repro_torch.core.comm.StackedGroup` or
    :class:`~repro_torch.core.comm.DistGroup`): each held rank computes
    its gradients on its shard of the batch (rows split evenly, in rank
    order; on a ``StackedGroup`` a loop over the ranks with one shared
    model), then the bucketed int8 quantized circulant allreduce with
    error feedback syncs them -- after the backward
    (``compressed_grad_sync``), or inside it through per-bucket markers
    (``stream_grad_sync=True``, ``streamed_sync_params``; on the card over
    a ``StackedGroup`` each bucket's sync runs on a side stream under the
    backward of the buckets after it, and the step waits for them once
    the backward returns).  The error
    buckets ride in ``state["gsync_err"]`` as ``[len(group.ranks),
    bucket]`` f32.

Attention and the SSD scan run their plain versions (``backend="torch"``),
as the reference trains through jnp: the CUDA kernels have no backward.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch
from torch import nn

from ..core.comm import StackedGroup, get_comm
from ..core.tree import tree_flatten, tree_unflatten
from ..models.common import ModelConfig
from ..models.convert import bind, stack_layers, unstack_layers
from ..models.transformer import init_params, loss_fn
from ..optim.adamw import AdamWConfig, apply_updates, init_opt_state
from ..optim.compression import (
    _bucket_rows,
    compressed_grad_sync,
    init_grad_sync_state,
    inv,
    make_bucket_spec,
    streamed_sync_params,
    wait_streamed_sync,
)

__all__ = ["TrainConfig", "grad_bucket_spec", "init_train_state",
           "train_state_shape", "make_train_step", "make_eval_step"]


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "full"
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    grad_sync: str = "auto"          # auto | compressed
    # gradient-accumulation dtype: f32 default; bf16 halves the
    # accumulator at ~3 bits of accumulation precision over 16 microbatches.
    grad_acc_dtype: str = "float32"
    # compressed grad-sync knobs (ignored for grad_sync='auto'): the round
    # steps of the quantized circulant allreduce ("cuda": the kernels on a
    # CUDA tensor; "torch": their plain versions) and the target f32
    # payload of a gradient bucket.
    grad_sync_backend: str = "cuda"  # cuda | torch
    bucket_bytes: int = 4 << 20
    # run each bucket's quantized allreduce inside the backward through a
    # per-bucket autograd marker instead of after it.  Ignored for
    # grad_sync='auto'.
    stream_grad_sync: bool = False


def _shapes(cfg: ModelConfig):
    """A ``meta`` model (structure, no storage) and the reference-layout
    tree of its parameters as ``meta`` tensors."""
    shell = init_params(cfg, device="meta")
    return shell, stack_layers(shell, cfg)


def grad_bucket_spec(cfg: ModelConfig, tcfg: TrainConfig):
    """The frozen gradient BucketSpec of this model and config: from the
    reference's stacked tree (shapes only, no allocation), so the buckets
    and their quantization blocks are the reference's."""
    return make_bucket_spec(_shapes(cfg)[1], bucket_bytes=tcfg.bucket_bytes)


def _held(group) -> int:
    return 1 if group is None else len(group.ranks)


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, generator=None, *,
                     device=None, group=None, params=None) -> Dict[str, Any]:
    """``{"params", "opt"}`` (and ``"gsync_err"`` for compressed sync): the
    parameters in the reference's stacked layout -- a copy of ``params``
    (a :class:`~repro_torch.models.transformer.Model` or such a tree), by
    default of ``init_params(cfg, generator, device=device)`` -- and zero
    AdamW moments; the error buckets are ``[len(group.ranks), bucket]``."""
    if params is None:
        params = init_params(cfg, generator, device=device)
    if isinstance(params, nn.Module):
        params = stack_layers(params, cfg)
    leaves, treedef = tree_flatten(params)
    tree = tree_unflatten(treedef, [x.detach().clone() for x in leaves])
    dev = leaves[0].device
    if group is not None and group.device != dev:
        raise ValueError(f"parameters on {dev}, the group's ranks on {group.device}")
    state = {"params": tree, "opt": init_opt_state(tcfg.opt, tree)}
    if tcfg.grad_sync == "compressed":
        state["gsync_err"] = init_grad_sync_state(
            grad_bucket_spec(cfg, tcfg), _held(group), device=dev)
    return state


def train_state_shape(cfg: ModelConfig, tcfg: TrainConfig, dp: int = 1):
    """The train state as ``meta`` tensors (shapes and dtypes, no storage;
    the dry-run path): ``init_train_state`` on ``device="meta"``, the
    error buckets ``[dp, bucket]``."""
    state = init_train_state(cfg, tcfg, device="meta")
    if tcfg.grad_sync == "compressed":
        state["gsync_err"] = tuple(torch.empty((dp, s), dtype=torch.float32,
                                               device="meta")
                                   for s in grad_bucket_spec(cfg, tcfg).bucket_sizes)
    return state


def _rows(batch, n: int) -> List[Dict[str, torch.Tensor]]:
    """[B, ...] leaves -> n batches of [B/n, ...] (contiguous rows, in
    order): the microbatches of a batch, or the ranks' shards of one."""
    def split(x):
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} % {n} != 0")
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, group=None):
    """Build the ``(state, batch) -> (state, metrics)`` step.

    ``batch``: {"tokens", "labels"} [B, S] (NumPy arrays or tensors): the
    global batch, except on a ``DistGroup`` with compressed sync, where
    each process passes its own shard.  ``grad_sync="compressed"`` with no
    group (or p == 1) takes the plain step and passes the error state
    through.  Metrics: ``loss``, ``ce``, ``aux`` (their means over the
    ranks), ``grad_norm`` and ``lr``."""
    return _build_step(cfg, tcfg, group)


def _count_step(cfg: ModelConfig, tcfg: TrainConfig, counter):
    """The plain step for counting its ops on ``meta`` leaves: with
    microbatches it runs the first one inside ``counter.repeat(n)``, so it
    is counted once for each of the n, then the update once.  It refuses
    leaves that hold data, whose update this would get wrong."""
    return _build_step(cfg, tcfg, None, counter)


def _build_step(cfg: ModelConfig, tcfg: TrainConfig, group=None, counter=None):
    if tcfg.grad_sync not in ("auto", "compressed"):
        raise ValueError(f"unknown grad_sync {tcfg.grad_sync!r}")
    shell, _ = _shapes(cfg)
    nbm = int(tcfg.microbatches)
    acc_dt = torch.bfloat16 if tcfg.grad_acc_dtype == "bfloat16" else torch.float32
    spec = grad_bucket_spec(cfg, tcfg) if tcfg.grad_sync == "compressed" else None

    def loss_of(leaves, treedef, batch):
        model = bind(shell, unstack_layers(shell, cfg, tree_unflatten(treedef, leaves)))
        return loss_fn(model, cfg, batch, remat=tcfg.remat, backend="torch")

    def grad_of(leaves, treedef, batch):
        ins = [x.detach().requires_grad_() for x in leaves]
        loss, metrics = loss_of(ins, treedef, batch)
        grads = torch.autograd.grad(loss, ins)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def accumulate(leaves, treedef, mbs):
        """Raw gradient and loss sums over microbatches, in acc_dt (with a
        counter, the first microbatch counted for all of them)."""
        g_acc = [torch.zeros(tuple(x.shape), dtype=acc_dt, device=x.device)
                 for x in leaves]
        l_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        metrics = {}
        scope = contextlib.nullcontext() if counter is None else counter.repeat(len(mbs))
        with scope:
            for mb in (mbs if counter is None else mbs[:1]):
                loss, metrics, g = grad_of(leaves, treedef, mb)
                for a, b in zip(g_acc, g):
                    a += b.to(a.dtype)
                l_acc = l_acc + loss
                del g
        return g_acc, l_acc, metrics

    def compute_grads(leaves, treedef, batch):
        if nbm > 1:
            g_sum, loss_sum, metrics = accumulate(leaves, treedef, _rows(batch, nbm))
            # the jitted reference divides by the constant nbm, which XLA
            # turns into a multiplication by its reciprocal
            return loss_sum * inv(nbm), metrics, [g * inv(nbm) for g in g_sum]
        return grad_of(leaves, treedef, batch)

    def finish(state, grads, loss, metrics):
        _, _, opt_metrics = apply_updates(tcfg.opt, state["params"], grads,
                                          state["opt"])
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return state, metrics

    def to_device(batch, dev):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def plain_step(state, batch):
        leaves, treedef = tree_flatten(state["params"])
        if counter is not None and any(x.device.type != "meta" for x in leaves):
            raise ValueError("a counted step takes meta leaves only")
        batch = to_device(batch, leaves[0].device)
        loss, metrics, grads = compute_grads(leaves, treedef, batch)
        return finish(state, tree_unflatten(treedef, grads), loss, metrics)

    if tcfg.grad_sync != "compressed" or group is None or group.p == 1:
        return plain_step

    p, lr = group.p, len(group.ranks)
    backend = tcfg.grad_sync_backend

    def pmean(values: List[torch.Tensor]) -> torch.Tensor:
        """The mean over all p ranks of one scalar a held rank."""
        v = torch.stack(values)
        if not isinstance(group, StackedGroup):
            v = get_comm(group, backend=backend).allgather(v)
        return v.sum() * inv(p)

    def synced_step(state, batch):
        leaves, treedef = tree_flatten(state["params"])
        shards = _rows(to_device(batch, leaves[0].device), lr)
        grads, losses, mets = None, [], []
        for i, shard in enumerate(shards):
            loss, metrics, g = compute_grads(leaves, treedef, shard)
            if grads is None:
                grads = [torch.empty((lr,) + tuple(x.shape), dtype=x.dtype,
                                     device=x.device) for x in g]
            for row, x in zip(grads, g):
                row[i] = x
            del g
            losses.append(loss)
            mets.append(metrics)
        mean, new_errs = compressed_grad_sync(
            tree_unflatten(treedef, grads), state["gsync_err"], group, spec,
            backend=backend)
        del grads
        metrics = {k: pmean([m[k] for m in mets]) for k in mets[0]}
        mean_leaves, _ = tree_flatten(mean)
        state["gsync_err"] = new_errs
        return finish(state, tree_unflatten(treedef, [m[0] for m in mean_leaves]),
                      pmean(losses), metrics)

    def streamed_step(state, batch):
        # Bucket streaming: the loss is computed THROUGH per-bucket sync
        # markers, so the backward runs bucket k's quantized allreduce
        # once its cotangents are complete.  With accumulation, the first
        # nbm-1 microbatches accumulate raw local gradients and only the
        # last microbatch's backward streams the sync of the total.
        leaves, treedef = tree_flatten(state["params"])
        shards = _rows(to_device(batch, leaves[0].device), lr)
        dev = leaves[0].device
        if nbm > 1:
            lasts, lead_losses, accs = [], [], None
            for i, shard in enumerate(shards):
                mbs = _rows(shard, nbm)
                g_lead, loss_lead, _ = accumulate(leaves, treedef, mbs[:-1])
                rows = _bucket_rows([x[None] for x in g_lead], spec)
                if accs is None:
                    accs = [torch.empty((lr, r.shape[1]), dtype=torch.float32,
                                        device=dev) for r in rows]
                for a, r in zip(accs, rows):
                    a[i] = r[0]
                del g_lead, rows
                lasts.append(mbs[-1])
                lead_losses.append(loss_lead)
        else:
            lasts = shards
            lead_losses = [torch.zeros((), dtype=torch.float32, device=dev)] * lr
            accs = [torch.zeros((lr, s), dtype=torch.float32, device=dev)
                    for s in spec.bucket_sizes]
        p_in = [x.detach().requires_grad_() for x in leaves]
        e_in = [e.detach().requires_grad_() for e in state["gsync_err"]]
        synced, _ = tree_flatten(streamed_sync_params(
            tree_unflatten(treedef, p_in), e_in, accs, spec, group,
            backend=backend, accum_scale=1.0 / nbm))
        total, losses, mets = 0.0, [], []
        for i, mb in enumerate(lasts):
            loss, metrics = loss_of([x[i] for x in synced], treedef, mb)
            total = total + loss
            losses.append((lead_losses[i] + loss.detach()) * inv(nbm))
            mets.append({k: v.detach() for k, v in metrics.items()})
        grads = torch.autograd.grad(total, p_in + e_in)
        # the bucket syncs may still run on their side stream
        wait_streamed_sync(group, dev)
        del synced, total
        state["gsync_err"] = tuple(grads[len(p_in):])
        metrics = {k: pmean([m[k] for m in mets]) for k in mets[0]}
        return finish(state, tree_unflatten(treedef, list(grads[:len(p_in)])),
                      pmean(losses), metrics)

    return streamed_step if tcfg.stream_grad_sync else synced_step


def make_eval_step(cfg: ModelConfig):
    """``(params, batch) -> loss`` with no gradient and no remat; ``params``
    in the reference's stacked layout (``state["params"]``)."""
    shell, _ = _shapes(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        model = bind(shell, unstack_layers(shell, cfg, params))
        dev = tree_flatten(params)[0][0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, _ = loss_fn(model, cfg, batch, remat="none", backend="torch")
        return loss

    return eval_step
