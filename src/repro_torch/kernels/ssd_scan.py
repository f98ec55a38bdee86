"""Mamba2 SSD chunked scan: the checked, counted wrapper of the CUDA kernel
and its plain version.

Port of the TPU kernel ``repro.kernels.ssd_scan.ssd_scan`` with its
wrapper ``repro.kernels.ops.mamba2_ssd``; the kernel is
``csrc/ssd_scan.cu`` (CUDA C++ for sm_90a, built by
:mod:`repro_torch.kernels._build` at the first launch).

:func:`ssd_scan` keeps the wrapper's layout, all float32: x
``[B, S, H, P]``, B/C ``[B, S, G, N]`` (head h reads group
``h // (H // G)``), dt ``[B, S, H]``, A_log/D ``[H]`` -> y ``[B, S, H, P]``.
On CPU tensors (and on ``meta`` ones, which hold no data for a kernel:
the dry run) it runs :func:`ssd_chunked`, the plain version (a port of
``repro.models.ssm.ssd_chunked``); on CUDA tensors it launches the kernel,
adds one to :data:`LAUNCHES`, and raises if the launch failed.  There is
no fallback from a CUDA tensor to the plain version.  The kernel has no
backward: on the card an operand that requires grad under grad mode
raises ``ValueError`` (the plain version on a CPU tensor keeps autograd).

The plain scan is three phases, each the counterpart of the kernel's
phase of the same name: :func:`ssd_chunk_states`, :func:`ssd_state_pass`
and :func:`ssd_chunk_outputs`.  :func:`chunk_states`, :func:`state_pass`
and :func:`chunk_outputs` launch one phase of the kernel alone (on CPU
tensors, the plain phase); they are for checking and timing each phase,
and count no launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import refuse_grad

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES = {"ssd_scan": 0}
MAX_HEAD_DIM = 128            # output columns a thread block keeps in registers


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0


def _chunks(t: torch.Tensor, Q: int) -> torch.Tensor:
    """[B, S, ...] -> [B, nc, Q, ...], the ragged last chunk padded with 0."""
    nc = -(-t.shape[1] // Q)
    pad = nc * Q - t.shape[1]
    if pad:
        t = F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, pad))
    return t.reshape(t.shape[0], nc, Q, *t.shape[2:])


def ssd_chunk_states(x, B_, dt, A_log, chunk: int):
    """Phase 1 of the chunked scan: each chunk on its own.

    Returns ``cum`` [B, nc, Q, H], the in-chunk cumulative log-decay
    ``sum_{k <= i} dt_k A``, and ``sloc`` [B, nc, H, N, P], the state a
    chunk leaves from a zero start:
    ``sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T``.
    """
    Q = min(chunk, x.shape[1])
    rep = x.shape[2] // B_.shape[2]
    A = -torch.exp(A_log)                                 # [H] negative
    xc, Bc, dtc = _chunks(x, Q), _chunks(B_, Q), _chunks(dt, Q)
    cum = torch.cumsum(dtc * A, dim=2)                    # within-chunk log-decay
    Bh = Bc.repeat_interleave(rep, dim=3)                 # [B,nc,Q,H,N]
    # chunk-final states: S_c = sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # [B,nc,Q,H]
    sloc = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", decay_to_end * dtc, Bh, xc)
    return cum, sloc


def ssd_state_pass(cum, sloc):
    """Phase 2: the states entering each chunk, [B, nc, H, N, P]:
    zero before the first, then ``s = s exp(cum_Q[c]) + sloc[c]``."""
    chunk_decay = torch.exp(cum[:, :, -1, :])             # [B,nc,H]
    s = torch.zeros_like(sloc[:, 0])
    s_prevs = []
    for c in range(sloc.shape[1]):                        # state entering chunk c
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + sloc[:, c]
    return torch.stack(s_prevs, dim=1)                    # [B,nc,H,N,P]


def ssd_chunk_outputs(x, B_, C_, dt, D, cum, s_prev, chunk: int):
    """Phase 3: y [B, S, H, P] from each chunk's inputs and the state
    entering it: ``y_i = exp(cum_i) C_i . s_prev
    + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + D x_i``."""
    S = x.shape[1]
    Q = min(chunk, S)
    rep = x.shape[2] // B_.shape[2]
    xc, Bc, Cc, dtc = (_chunks(t, Q) for t in (x, B_, C_, dt))
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
    # inter-chunk: y_i += C_i . (exp(cum_i) * S_prev)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Ch, s_prev) * torch.exp(cum)[..., None]
    Bsz, nc, _, H, Pd = xc.shape
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, Pd)
    y = y + xc.reshape(Bsz, nc * Q, H, Pd) * D[None, None, :, None]
    return y[:, :S] if nc * Q != S else y


def ssd_chunked(x, B_, C_, dt, A_log, D, chunk: int):
    """Plain chunked SSD scan, the three phases in turn.

    x:  [B, S, H, P]   (values)
    B_: [B, S, G, N]   (input projections; broadcast over H//G heads)
    C_: [B, S, G, N]
    dt: [B, S, H]      (positive step sizes)
    Returns y: [B, S, H, P].
    """
    cum, sloc = ssd_chunk_states(x, B_, dt, A_log, chunk)
    s_prev = ssd_state_pass(cum, sloc)
    return ssd_chunk_outputs(x, B_, C_, dt, D, cum, s_prev, chunk)


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
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def _states_scratch(x, B_, chunk):
    """Phases 1-2's scratch: cum [B, nc, Q, H] and states [B, nc, H, N, P]."""
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    nc = -(-S // Q)
    return (torch.empty((Bsz, nc, Q, H), dtype=x.dtype, device=x.device),
            torch.empty((Bsz, nc, H, B_.shape[3], P), dtype=x.dtype, device=x.device))


def _cb_scratch(x, B_, chunk):
    """Phase 3's scratch: the C B^T tiles [B, G, nc, pairs, 64, 64] of the
    64-row tiles i >= j of each chunk."""
    Q = min(chunk, x.shape[1])
    nc = -(-x.shape[1] // Q)
    tiles = -(-Q // 64)
    return torch.empty((x.shape[0], B_.shape[2], nc, tiles * (tiles + 1) // 2, 64, 64),
                       dtype=x.dtype, device=x.device)


def _sizes(x, B_, chunk):
    Bsz, S, H, P = x.shape
    return Bsz, S, H, P, B_.shape[2], B_.shape[3], chunk


def _contiguous(*ts) -> None:
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _check_states(cum, states, want, device) -> None:
    """cum [B, nc, Q, H] and states [B, nc, H, N, P] must have the sizes
    ``want`` = (B, nc, Q, H, N, P) and be float32 on ``device``."""
    Bsz, nc, Q, H, N, P = want
    if tuple(cum.shape) != (Bsz, nc, Q, H) or tuple(states.shape) != (Bsz, nc, H, N, P):
        raise ValueError(f"cum {tuple(cum.shape)} and states {tuple(states.shape)} "
                         f"do not fit {want} = (B, nc, Q, H, N, P)")
    for t in (cum, states):
        if t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"cum and states must be float32 on {device}")
    _contiguous(cum, states)


def ssd_scan(x, B_, C_, dt, A_log, D, *, chunk: int = 64) -> torch.Tensor:
    """y = SSD(x) + D*x over chunks of ``chunk`` positions, float32
    (layouts in the module docstring).  On the card one launch runs the
    three phases (chunk states, state pass, chunk outputs) as four kernels
    on the current stream (the outputs phase first makes the C B^T tiles
    its group's heads share), with their scratch from ``torch.empty``."""
    if not _check(x, B_, C_, dt, A_log, D, chunk):
        return ssd_chunked(x, B_, C_, dt, A_log, D, chunk)
    refuse_grad("ssd_scan", x, B_, C_, dt, A_log, D)
    from . import _build

    _contiguous(x, B_, C_, dt, A_log, D)
    y = torch.empty_like(x)
    cum, states = _states_scratch(x, B_, chunk)
    cb = _cb_scratch(x, B_, chunk)
    _build.launch("ssd_scan", "ssd_scan", x.device, x.data_ptr(),
                  B_.data_ptr(), C_.data_ptr(), dt.data_ptr(),
                  A_log.data_ptr(), D.data_ptr(), y.data_ptr(),
                  cum.data_ptr(), states.data_ptr(), cb.data_ptr(),
                  *_sizes(x, B_, chunk))
    LAUNCHES["ssd_scan"] += 1
    return y


# Each phase of the kernel on its own, against its plain version: for the
# card's checks and timings; :func:`ssd_scan` is what the model calls.

def chunk_states(x, B_, C_, dt, A_log, D, *, chunk: int = 64):
    """Phase 1: (cum, sloc) as :func:`ssd_chunk_states`."""
    if not _check(x, B_, C_, dt, A_log, D, chunk):
        return ssd_chunk_states(x, B_, dt, A_log, chunk)
    from . import _build

    _contiguous(x, B_, dt, A_log)
    cum, states = _states_scratch(x, B_, chunk)
    _build.launch("ssd_scan", "ssd_chunk_states", x.device, x.data_ptr(),
                  B_.data_ptr(), dt.data_ptr(), A_log.data_ptr(), cum.data_ptr(),
                  states.data_ptr(), *_sizes(x, B_, chunk))
    return cum, states


def state_pass(cum, sloc):
    """Phase 2: the states entering each chunk, as :func:`ssd_state_pass`;
    on the card ``sloc`` becomes them in place (and is returned)."""
    if cum.device.type != "cuda":
        return ssd_state_pass(cum, sloc)
    from . import _build

    Bsz, nc, Q, H = cum.shape
    N, P = sloc.shape[3:]
    _check_states(cum, sloc, (Bsz, nc, Q, H, N, P), cum.device)
    # the kernel needs only nc and Q of S and chunk, and no group count
    _build.launch("ssd_scan", "ssd_state_pass", cum.device, cum.data_ptr(),
                  sloc.data_ptr(), Bsz, nc * Q, H, P, 1, N, Q)
    return sloc


def chunk_outputs(x, B_, C_, dt, A_log, D, cum, s_prev, *, chunk: int = 64):
    """Phase 3: y as :func:`ssd_chunk_outputs`."""
    if not _check(x, B_, C_, dt, A_log, D, chunk):
        return ssd_chunk_outputs(x, B_, C_, dt, D, cum, s_prev, chunk)
    from . import _build

    _contiguous(x, B_, C_, dt, D)
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    _check_states(cum, s_prev, (Bsz, -(-S // Q), Q, H, B_.shape[3], P), x.device)
    y = torch.empty_like(x)
    cb = _cb_scratch(x, B_, chunk)
    _build.launch("ssd_scan", "ssd_chunk_outputs", x.device, x.data_ptr(),
                  B_.data_ptr(), C_.data_ptr(), dt.data_ptr(), D.data_ptr(),
                  cum.data_ptr(), s_prev.data_ptr(), cb.data_ptr(), y.data_ptr(),
                  *_sizes(x, B_, chunk))
    return y
