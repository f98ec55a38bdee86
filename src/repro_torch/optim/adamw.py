"""AdamW on a tree of tensors.

Port of ``repro.optim.adamw``: a configurable moment dtype (bf16 moments
save 4 bytes a parameter), global-norm gradient clipping, decoupled
weight decay on matrices only (leaves of two or more dimensions) and a
linear-warmup cosine schedule.  The arithmetic is the reference's, in
f32.  ``apply_updates`` updates the parameters and moments in place,
under ``torch.no_grad()``; the trainer hands it the reference's stacked
tree, so "matrix" means what it means there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core.tree import tree_flatten, tree_unflatten

__all__ = ["AdamWConfig", "init_opt_state", "schedule", "global_norm",
           "apply_updates"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"      # "float32" | "bfloat16"
    warmup_steps: int = 100
    total_steps: int = 10000


def _mdtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def init_opt_state(cfg: AdamWConfig, params):
    """Zero moments shaped like each parameter, in the moment dtype, on
    its device, and the step count (an int32 scalar)."""
    leaves, treedef = tree_flatten(params)
    dt = _mdtype(cfg)

    def zeros():
        return tree_unflatten(treedef, [torch.zeros(tuple(p.shape), dtype=dt,
                                                    device=p.device)
                                        for p in leaves])

    dev = leaves[0].device if leaves else None
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), f32: linear warmup
    over ``warmup_steps``, then a cosine from ``lr`` down to 0.1 ``lr`` at
    ``total_steps``."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    leaves, _ = tree_flatten(tree)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(total)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    updated and ``state["step"]`` advanced.  Returns ``(params, state,
    {"grad_norm", "lr"})``."""
    dt = _mdtype(cfg)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    flat_p, _ = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
        flat_g = [g * scale.to(g.dtype) for g in flat_g]
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    flat_mu, _ = tree_flatten(state["mu"])
    flat_nu, _ = tree_flatten(state["nu"])
    for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu):
        g32 = g.float()
        # the jitted reference contracts mu*b1 + (1-b1)*g (and the nu
        # update alike) into one fused multiply-add: addcmul rounds once
        mu32 = torch.addcmul((1 - b1) * g32, mu.float(), _f32(b1, g32))
        nu32 = torch.addcmul((1 - b2) * g32 * g32, nu.float(), _f32(b2, g32))
        delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        mu.copy_(mu32.to(dt))
        nu.copy_(nu32.to(dt))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
