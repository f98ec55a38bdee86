"""Primitive layers: norms, MLPs, embeddings, RoPE.

Port of ``repro.models.layers``: the initializers draw from an explicit
``torch.Generator`` (on the target device, or on the CPU for a ``meta``
model that holds shapes only), the apply functions take the owning
module (or tensor) and the input.  Weights are ``[d_in, d_out]`` as in
the reference (``x @ w``).  The training loss is :func:`cross_entropy`
and its chunked form :func:`chunked_softmax_xent`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    """A model parameter.  It needs no gradient: the trainer differentiates
    the reference-layout tensors it binds in their place
    (:func:`repro_torch.models.convert.bind`)."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, device=None) -> nn.Parameter:
    s = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen,
                    device=device or gen.device) * s
    return param(w.to(dtype))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, returned in x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def init_rms_norm(d: int, device, dtype=torch.float32) -> nn.Parameter:
    return param(torch.ones((d,), dtype=dtype, device=device))


class SwiGLU(nn.Module):
    """``w_gate``, ``w_up`` [d, f] and ``w_down`` [f, d]."""

    def __init__(self, gen: torch.Generator, d: int, f: int, dtype, device=None):
        super().__init__()
        self.w_gate = dense_init(gen, d, f, dtype, device=device)
        self.w_up = dense_init(gen, d, f, dtype, device=device)
        self.w_down = dense_init(gen, f, d, dtype, device=device)


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


class GeluMLP(nn.Module):
    """``w_in`` [d, f] and ``w_out`` [f, d] (the encoder-decoder MLP)."""

    def __init__(self, gen: torch.Generator, d: int, f: int, dtype, device=None):
        super().__init__()
        self.w_in = dense_init(gen, d, f, dtype, device=device)
        self.w_out = dense_init(gen, f, d, dtype, device=device)


def gelu_mlp_apply(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, the default of the reference's ``jax.nn.gelu``
    (torch's default is the erf form)."""
    return F.gelu(x @ p.w_in, approximate="tanh") @ p.w_out


# ---------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] integers.  Rotates the two
    halves of each head (not interleaved pairs), in f32."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)   # [hd/2]
    ang = positions[..., :, None].float() * freqs                   # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- embeddings


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device=None) -> nn.Parameter:
    t = torch.randn((vocab, d), generator=gen, device=device or gen.device) * 0.02
    return param(t.to(dtype))


def embed_apply(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` as ``jnp.take(table, tokens, axis=0)`` gives it:
    ids in [-vocab, vocab) gather (negatives wrap), any other id gives a
    NaN row.  Clamp, gather, then mask: no host synchronisation, and no
    device-side assert on a bad id."""
    vocab = table.shape[0]
    inside = (tokens >= -vocab) & (tokens < vocab)
    rows = table[torch.where(inside, tokens, 0) % vocab]
    return torch.where(inside[..., None], rows, torch.full(
        (), float("nan"), dtype=table.dtype, device=table.device))


def unembed_apply(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: [..., d] -> logits [..., vocab]; table: [vocab, d]."""
    return x @ table.T


# ----------------------------------------------------------------- loss


def _nll(logits: torch.Tensor, labels: torch.Tensor, ignore: int):
    """Per-position negative log-likelihood in f32 and the mask of
    positions that count (label != ignore)."""
    mask = (labels != ignore).float()
    safe = torch.where(labels == ignore, 0, labels)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.take_along_dim(lf, safe[..., None].long(), dim=-1)[..., 0]
    return (lse - gold) * mask, mask


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored positions.  logits [..., V], labels [...]."""
    nll, mask = _nll(logits, labels, ignore)
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def chunked_softmax_xent(hidden: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, ignore: int = -100,
                         chunk: int = 512) -> torch.Tensor:
    """LM-head cross entropy that never holds the [B, S, V] logits: over
    sequence chunks, each chunk's logits ``hidden_chunk @ table.T``
    reduced to its nll sum and count.  Each chunk runs under
    ``torch.utils.checkpoint`` (as the reference's ``jax.checkpoint``), so
    the backward recomputes its logits instead of keeping them: peak
    logits memory is [B, chunk, V]."""
    from torch.utils.checkpoint import checkpoint

    B, S, d = hidden.shape
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore)

    def body(h, lab):
        nll, mask = _nll(h @ table.T, lab, ignore)
        return nll.sum(), mask.sum()

    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        part, n = checkpoint(body, hidden[:, sl], labels[:, sl],
                             use_reentrant=False)
        nll_sum = nll_sum + part
        cnt = cnt + n
    return nll_sum / torch.clamp_min(cnt, 1.0)
