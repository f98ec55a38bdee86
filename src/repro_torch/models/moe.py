"""Mixture-of-experts block: top-k routing with capacity-based dispatch.

Port of ``repro.models.moe``.  The router scores every token in f32 and
keeps its top K experts; each (token, k) slot takes the next free row of
its expert's buffer ``[E, C, d]``, in token-major order, and a slot past
the expert's capacity C is dropped.  The experts are one SwiGLU each,
run as batched products over E (cuBLAS, as the reference's einsums are
XLA's: the block has no Pallas kernel, so its plain torch is the path on
both backends), and each token sums its slots' outputs weighted by
their renormalised gates.  Shared experts (DeepSeek-style) are one
SwiGLU of width ``d_expert * n_shared`` applied to every token.

Four things must agree with the reference to the bit, or the routing
diverges:

  * the capacity ``C = max(1, int(T * K * capacity_factor / E))`` of
    this call's own ``T = B * S`` tokens, so prefill and decode get
    different capacities (2 x 4096 tokens of deepseek-moe-16b: C = 960;
    a decode step over 4 slots: C = 1, and the slots compete for it);
  * the top-K tie order: ``jax.lax.top_k`` puts the lower index first
    among equal values, and ``torch.topk`` does not, so the top K are the
    first K of a stable descending sort (a zero input row gives equal
    probabilities over all E);
  * the slot order: a stable sort of the flat expert ids;
  * the dispatch adds into the buffer.  A dropped slot points at row
    C - 1 of its expert and carries a zero; a plain indexed set there
    would write duplicates, of which any one may win (on the card, the
    zero may wipe the kept token).

The stages are functions of their own (:func:`route`, :func:`dispatch`,
:func:`expert_ffn`, :func:`combine`) so that each can be timed alone.
None of them synchronises with the host.  The reference's expert-parallel
sharding hints (``set_default_ep_spec``, ``ep_spec``, ``_constrain``)
have no counterpart on one card and are left out, as ``hints`` is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig
from .layers import SwiGLU, dense_init, param, swiglu_apply


class MoE(nn.Module):
    """``router`` [d, E] f32 (whatever the model's dtype), ``w_gate`` and
    ``w_up`` [E, d, f], ``w_down`` [E, f, d], and with ``n_shared > 0``
    the ``shared`` SwiGLU of width ``f * n_shared``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        mo = cfg.moe
        d, f, E = cfg.d_model, mo.d_expert, mo.n_experts
        dev = device or gen.device
        self.router = dense_init(gen, d, E, torch.float32, device=dev)

        def experts(d_in, d_out):
            # scaled in place: one f32 copy of an expert stack at a time
            # (deepseek-v3's is 15 GB)
            w = torch.randn((E, d_in, d_out), generator=gen, device=dev)
            w /= np.sqrt(d_in)
            return param(w.to(dtype))

        self.w_gate, self.w_up, self.w_down = experts(d, f), experts(d, f), experts(f, d)
        self.shared = (SwiGLU(gen, d, f * mo.n_shared, dtype, dev)
                       if mo.n_shared else None)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows of each expert's buffer for a call of ``tokens`` tokens."""
    mo = cfg.moe
    return max(1, int(tokens * mo.top_k * mo.capacity_factor / mo.n_experts))


class Routing(NamedTuple):
    """Where each (token, k) slot goes, flat in token-major order [T*K]:
    its ``expert``, its row ``pos`` in that expert's buffer (``C - 1``
    for a dropped slot), whether it is kept, and its gate [T, K]."""

    gate: torch.Tensor
    expert: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """Tokens xt [T, d] -> (:class:`Routing`, the load-balancing aux loss
    f32).  Every sort is stable, so a recomputation (remat) routes as the
    first pass did."""
    mo = cfg.moe
    T = xt.shape[0]
    E, K = mo.n_experts, mo.top_k
    C = capacity(cfg, T)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)              # [T, E]
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = vals[:, :K], idx[:, :K]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # load-balancing aux loss (Switch-style); the counts carry no gradient
    flat_e = expert_idx.reshape(-1)                                   # [T*K]
    TK = flat_e.shape[0]
    counts = torch.zeros((E,), dtype=torch.float32, device=xt.device).index_add_(
        0, flat_e, torch.ones((TK,), dtype=torch.float32, device=xt.device))
    aux = E * torch.sum(probs.mean(dim=0) * (counts / (T * K)))

    # each slot's row within its expert, from a stable sort of the ids
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, torch.arange(E, device=xt.device), side="left")
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(TK, device=xt.device) - first[se]
    keep = pos < C
    safe_pos = torch.where(keep, pos, C - 1)
    return Routing(gate, flat_e, safe_pos, keep, C), aux


def dispatch(xt: torch.Tensor, r: Routing, cfg: ModelConfig) -> torch.Tensor:
    """The expert buffer [E, C, d]: each kept slot's token in its row,
    zeros elsewhere.  Dropped slots add a zero into row C - 1.  The adds
    go through ``index_add`` on the flat row index ``expert * C + pos``
    (atomic adds on the card: exact here, since a row receives one token
    and zeros), not an accumulating ``index_put``, whose CUDA kernel sorts
    the indices and sums each row's duplicates serially."""
    T, d = xt.shape
    K, E, C = cfg.moe.top_k, cfg.moe.n_experts, r.capacity
    xe = xt[:, None].expand(T, K, d).reshape(T * K, d)                # token-major
    xe = torch.where(r.keep[:, None], xe, torch.zeros((), dtype=xt.dtype,
                                                      device=xt.device))
    buf = torch.zeros((E * C, d), dtype=xt.dtype, device=xt.device)
    return buf.index_add(0, r.expert * C + r.pos, xe).view(E, C, d)


def expert_ffn(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its rows, batched over E: [E, C, d]."""
    g = F.silu(torch.bmm(buf, p.w_gate))
    return torch.bmm(g * torch.bmm(buf, p.w_up), p.w_down)


def combine(y: torch.Tensor, r: Routing, T: int) -> torch.Tensor:
    """Each token's slots' outputs, weighted by their gates (zero where
    dropped, cast to y's dtype before the product), summed: [T, d]."""
    ye = y[r.expert, r.pos]                                           # [T*K, d]
    w = (r.gate.reshape(-1, 1) * r.keep[:, None]).to(y.dtype)
    return (ye * w).reshape(T, -1, y.shape[-1]).sum(dim=1)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x [B, S, d] -> (out [B, S, d] in x's dtype, aux_loss f32)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r, aux = route(p, xt, cfg)
    out = combine(expert_ffn(p, dispatch(xt, r, cfg)), r, B * S)
    if p.shared is not None:
        out = out + swiglu_apply(p.shared, xt)
    return out.reshape(B, S, d).to(x.dtype), aux
