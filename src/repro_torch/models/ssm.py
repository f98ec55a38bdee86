"""Mamba2 / SSD (state-space duality) block, chunked scan formulation.

Port of ``repro.models.ssm``.  Per head h with scalar decay
a_t = exp(dt_t * A_h), state S in R^{N x P}:

    S_t = a_t S_{t-1} + dt_t B_t x_t^T ,   y_t = C_t^T S_t + D_h x_t

The full-sequence branch of :func:`ssm_block` runs the scan in the
hand-written CUDA kernel on a CUDA tensor (``backend="cuda"``) and the
plain chunked scan otherwise (:func:`ssd_chunked`, also what the kernel's
wrapper runs on a CPU tensor).  The decode branch is the single-token
recurrence in plain torch; the depthwise conv frontend keeps a
(d_conv-1)-deep state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd_scan import ssd_chunked, ssd_scan
from .attention import check_backend
from .common import ModelConfig
from .layers import dense_init, init_rms_norm, param, rms_norm

__all__ = ["Mamba2", "ssd_chunked", "ssd_reference", "ssm_block"]


class Mamba2(nn.Module):
    """``in_proj`` [d, 2*d_in + 2*G*N + H] (to z, x, B, C, dt), ``conv_w``
    [d_conv, channels] and ``conv_b``, ``A_log``/``D``/``dt_bias`` [H] in
    f32, ``out_norm`` [d_in] in f32 and ``out_proj`` [d_in, d]."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        s, d, dev = cfg.ssm, cfg.d_model, device or gen.device
        d_in = s.expand * d
        nh = d_in // s.head_dim
        conv_ch = d_in + 2 * s.n_groups * s.d_state
        self.in_proj = dense_init(gen, d, 2 * d_in + 2 * s.n_groups * s.d_state + nh,
                                  dtype, device=dev)
        self.conv_w = param((torch.randn((s.d_conv, conv_ch), generator=gen, device=dev)
                             * 0.1).to(dtype))
        self.conv_b = param(torch.zeros((conv_ch,), dtype=dtype, device=dev))
        self.A_log = param(torch.log(torch.linspace(1.0, 16.0, nh, device=dev)))
        self.D = param(torch.ones((nh,), device=dev))
        self.dt_bias = param(torch.zeros((nh,), device=dev))
        self.out_norm = init_rms_norm(d_in, dev)
        self.out_proj = dense_init(gen, d_in, d, dtype, device=dev)


def _split_proj(proj, cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    gs = s.n_groups * s.d_state
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * gs, nh], dim=-1)
    return z, xbc, dt, d_in, nh, gs


def _causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv along seq.  xbc: [B, S, Cch]; w: [K, Cch].
    Returns (silu(conv), the last K-1 inputs as the new state)."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[-1]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state  # [B, K-1, Cch]
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return F.silu(out), new_state


def ssm_block(p: Mamba2, x, cfg: ModelConfig, conv_state=None, ssd_state=None,
              *, backend: str = "cuda"):
    """Full-sequence Mamba2 block.  x: [B, S, d] -> [B, S, d]; the scan runs
    in the CUDA kernel with ``backend="cuda"`` on a CUDA tensor.

    If conv_state/ssd_state are given (decode), S must be 1 and the
    recurrent path is used; the states are updated in place and returned:
    (y, conv_state, ssd_state).
    """
    check_backend(backend)
    s = cfg.ssm
    B, S, d = x.shape
    proj = x @ p.in_proj
    z, xbc, dt, d_in, nh, gs = _split_proj(proj, cfg)
    dt = F.softplus(dt.float() + p.dt_bias)                          # [B,S,H]
    if conv_state is None:
        xbc, _ = _causal_conv(xbc, p.conv_w, p.conv_b)
        xs, B_, C_ = torch.split(xbc, [d_in, gs, gs], dim=-1)
        # the kernel takes contiguous f32 (the split leaves strided views)
        xh = xs.reshape(B, S, nh, s.head_dim).float().contiguous()
        Bh = B_.reshape(B, S, s.n_groups, s.d_state).float().contiguous()
        Ch = C_.reshape(B, S, s.n_groups, s.d_state).float().contiguous()
        if backend == "cuda":
            y = ssd_scan(xh, Bh, Ch, dt, p.A_log, p.D, chunk=s.chunk)
        else:
            y = ssd_chunked(xh, Bh, Ch, dt, p.A_log, p.D, s.chunk)
        y = y.reshape(B, S, d_in).to(x.dtype)
        y = y * F.silu(z)
        y = rms_norm(y, p.out_norm, cfg.norm_eps)
        return y @ p.out_proj
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xs, B_, C_ = torch.split(xbc, [d_in, gs, gs], dim=-1)
    xh = xs.reshape(B, nh, s.head_dim).float()                       # S == 1
    Bh = B_.reshape(B, s.n_groups, s.d_state).float()
    Ch = C_.reshape(B, s.n_groups, s.d_state).float()
    rep = nh // s.n_groups
    Bh = Bh.repeat_interleave(rep, dim=1)                            # [B,H,N]
    Ch = Ch.repeat_interleave(rep, dim=1)
    A = -torch.exp(p.A_log)
    dt1 = dt[:, 0]                                                   # [B,H]
    a = torch.exp(dt1 * A)                                           # [B,H]
    # S' = a S + dt B x^T ; y = C . S' + D x
    upd = dt1[..., None, None] * Bh[..., :, None] * xh[..., None, :]
    ssd_state.copy_(ssd_state * a[..., None, None] + upd)            # [B,H,N,P]
    conv_state.copy_(new_conv)
    y = torch.einsum("bhn,bhnp->bhp", Ch, ssd_state)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p.out_norm, cfg.norm_eps)
    return y @ p.out_proj, conv_state, ssd_state


def ssd_reference(x, B_, C_, dt, A_log, D):
    """O(S) sequential oracle for :func:`ssd_chunked` (tests).
    Layouts as ssd_chunked: x [B, S, H, P], B_/C_ [B, S, G, N], dt [B, S, H]."""
    Bsz, S, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    A = -torch.exp(A_log)
    Bh = B_.repeat_interleave(rep, dim=2)
    Ch = C_.repeat_interleave(rep, dim=2)
    s = torch.zeros((Bsz, H, N, Pd), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)                                  # [B,H]
        s = s * a[..., None, None] + dt[:, t, :, None, None] * (
            Bh[:, t, :, :, None] * x[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], s))
    return torch.stack(ys, dim=1) + x * D[None, None, :, None]
