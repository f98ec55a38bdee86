"""Mamba2 SSD chunked scan: the checked, counted wrapper of the CUDA kernel
and its plain version.

Port of the TPU kernel ``repro.kernels.ssd_scan.ssd_scan`` with its
wrapper ``repro.kernels.ops.mamba2_ssd``; the kernel is
``csrc/ssd_scan.cu`` (CUDA C++ for sm_90a, built by
:mod:`repro_torch.kernels._build` at the first launch).

:func:`ssd_scan` keeps the wrapper's layout, all float32: x
``[B, S, H, P]``, B/C ``[B, S, G, N]`` (head h reads group
``h // (H // G)``), dt ``[B, S, H]``, A_log/D ``[H]`` -> y ``[B, S, H, P]``.
On CPU tensors it runs :func:`ssd_chunked`, the plain version (a port of
``repro.models.ssm.ssd_chunked``); on CUDA tensors it launches the kernel,
adds one to :data:`LAUNCHES`, and raises if the launch failed.  There is
no fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES = {"ssd_scan": 0}
MAX_HEAD_DIM = 128            # output columns a thread block keeps in registers


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0


def ssd_chunked(x, B_, C_, dt, A_log, D, chunk: int):
    """Plain chunked SSD scan.

    x:  [B, S, H, P]   (values)
    B_: [B, S, G, N]   (input projections; broadcast over H//G heads)
    C_: [B, S, G, N]
    dt: [B, S, H]      (positive step sizes)
    Returns y: [B, S, H, P].
    """
    Bsz, S, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    A = -torch.exp(A_log)                                 # [H] negative
    xc = x.reshape(Bsz, nc, Q, H, Pd)
    Bc = B_.reshape(Bsz, nc, Q, G, N)
    Cc = C_.reshape(Bsz, nc, Q, G, N)
    dtc = dt.reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtc * A, dim=2)                    # within-chunk log-decay
    # intra-chunk dual form: L[i,j] = exp(cum_i - cum_j) for i >= j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,Q,Q,H]
    ii = torch.arange(Q, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # clamp BEFORE exp: masked (i < j) entries have seg > 0 and would overflow
    seg = torch.where(tri, seg, 0.0)
    Lmat = torch.where(tri, torch.exp(seg), 0.0)
    Bh = Bc.repeat_interleave(rep, dim=3)                 # [B,nc,Q,H,N]
    Ch = Cc.repeat_interleave(rep, dim=3)
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    w = cb * Lmat * dtc[:, :, None, :, :]                 # weight by dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    # chunk-final states: S_c = sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # [B,nc,Q,H]
    sloc = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", decay_to_end * dtc, Bh, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # [B,nc,H]
    s = torch.zeros((Bsz, H, N, Pd), dtype=x.dtype, device=x.device)
    s_prevs = []
    for c in range(nc):                                   # state entering chunk c
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + sloc[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                 # [B,nc,H,N,P]
    # inter-chunk: y_i += C_i . (exp(cum_i) * S_prev)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Ch, s_prevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, Pd)
    y = y + x.reshape(Bsz, nc * Q, H, Pd) * D[None, None, :, None]
    return y[:, :S] if pad else y


def _check(x, B_, C_, dt, A_log, D, chunk) -> bool:
    """Validate the operands; True when they lie on a CUDA device."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if B_.dim() != 4 or tuple(B_.shape[:2]) != (Bsz, S) or C_.shape != B_.shape:
        raise ValueError(f"B and C must be [{Bsz}, {S}, G, N], got "
                         f"{tuple(B_.shape)} and {tuple(C_.shape)}")
    G = B_.shape[2]
    if G < 1 or H % G:
        raise ValueError(f"{H} heads are not a multiple of {G} groups")
    if tuple(dt.shape) != (Bsz, S, H):
        raise ValueError(f"dt must be [{Bsz}, {S}, {H}], got {tuple(dt.shape)}")
    if tuple(A_log.shape) != (H,) or tuple(D.shape) != (H,):
        raise ValueError(f"A_log and D must be [{H}]")
    if min(x.shape) < 1 or B_.shape[3] < 1:
        raise ValueError("empty scan operands")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"head dim {P} > {MAX_HEAD_DIM}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    for t in (x, B_, C_, dt, A_log, D):
        if t.dtype != torch.float32:
            raise TypeError(f"scan operands must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def ssd_scan(x, B_, C_, dt, A_log, D, *, chunk: int = 64) -> torch.Tensor:
    """y = SSD(x) + D*x over chunks of ``chunk`` positions, float32
    (layouts in the module docstring)."""
    if not _check(x, B_, C_, dt, A_log, D, chunk):
        return ssd_chunked(x, B_, C_, dt, A_log, D, chunk)
    from . import _build

    for t in (x, B_, C_, dt, A_log, D):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    y = torch.empty_like(x)
    _build.launch("ssd_scan", "ssd_scan", x.device, x.data_ptr(),
                  B_.data_ptr(), C_.data_ptr(), dt.data_ptr(),
                  A_log.data_ptr(), D.data_ptr(), y.data_ptr(),
                  Bsz, S, H, P, G, N, chunk)
    LAUNCHES["ssd_scan"] += 1
    return y
