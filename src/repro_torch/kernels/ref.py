"""Plain PyTorch versions of the round-step kernels, and the naive
oracles of attention and the SSD scan.

Port of ``repro.kernels.ref`` (``block_pack_ref``, ``block_unpack_ref``,
``block_shuffle_ref``, ``block_shuffle_staged_ref``,
``block_acc_shuffle_ref``, ``block_acc_shuffle_staged_ref``,
``block_qacc_shuffle_ref``, ``attention_ref``, ``ssd_ref``).  The
round-step versions are the ``"torch"`` backend, what each
kernel wrapper runs on a CPU tensor, and what the tests and
``chip_smoke.py`` hold the CUDA kernels against.  Where the JAX oracles
return a new buffer, these update ``buffers`` in place and return it,
as the kernels do.  ``attention_ref`` (the whole S x S softmax) and
``ssd_ref`` (the sequential recurrence) are independent oracles of the
chunked plain versions beside the two model kernels
(:mod:`.flash_attention`, :mod:`.ssd_scan`).
"""

from __future__ import annotations

import math

import torch

from .quant_ops import fma_f32, quant_blocks, quant_error
from .reduce_ops import op_combine, op_identity


def attention_ref(q, k, v, *, causal=True, window=None):
    """Naive attention in f32.  q: [BH, Sq, hd]; k/v: [BH, Skv, hd(_v)]
    -> [BH, Sq, hd_v] in q's dtype."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    qi = torch.arange(q.shape[1], device=q.device)[:, None]
    kj = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
        if window is not None:
            mask = mask & (qi - kj < window)
    w = torch.softmax(torch.where(mask[None], s, -1e30), dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def ssd_ref(x, B_, C_, dt, A_log, D):
    """Sequential SSD recurrence in f32.  x: [BH, S, P]; B_/C_: [BH, S, N];
    dt: [BH, S]; A_log/D: one per row [BH] -> [BH, S, P]."""
    x, B_, C_, dt = x.float(), B_.float(), C_.float(), dt.float()
    A = -torch.exp(A_log)                                      # [BH]
    s = torch.zeros((x.shape[0], B_.shape[-1], x.shape[-1]), device=x.device)
    ys = []
    for t in range(x.shape[1]):
        a = torch.exp(dt[:, t] * A)
        s = s * a[:, None, None] + dt[:, t, None, None] * (
            B_[:, t, :, None] * x[:, t, None, :])
        ys.append(torch.einsum("bn,bnp->bp", C_[:, t], s))
    return torch.stack(ys, dim=1) + x * D[:, None, None]


def _rows(buffers: torch.Tensor) -> torch.Tensor:
    return torch.arange(buffers.shape[0], device=buffers.device)


def block_pack_ref(buffers: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buffers: [R, nslots, bs]; idx: [R] int32 -> packed [R, bs] with
    ``out[r] = buffers[r, idx[r]]``."""
    return buffers[_rows(buffers), idx.long()]


def block_unpack_ref(buffers: torch.Tensor, msg: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Scatter msg rows into per-row slots in place:
    ``buffers[r, idx[r]] = msg[r]``.  Returns ``buffers``."""
    buffers[_rows(buffers), idx.long()] = msg
    return buffers


def block_shuffle_ref(buffers: torch.Tensor, msg: torch.Tensor,
                      recv_idx: torch.Tensor, send_idx: torch.Tensor):
    """Fused unpack+pack: write msg at the recv slots (in place), then
    read the send slots from the UPDATED buffer (pipeline: a round-t
    delivery may be the round-t+1 send).  Returns (buffers, out_msg)."""
    rows = _rows(buffers)
    buffers[rows, recv_idx.long()] = msg
    return buffers, buffers[rows, send_idx.long()]


def block_shuffle_staged_ref(buffers: torch.Tensor, msg: torch.Tensor,
                             pre: torch.Tensor, recv_idx: torch.Tensor,
                             send_idx: torch.Tensor):
    """Overlap-staged shuffle: ``pre`` is the round-t+1 block packed from
    the PRE-update buffer.  Write msg at the recv slots (in place); the
    outgoing message is msg where ``send == recv`` (the only slot the
    update changed) and ``pre`` everywhere else -- equal to
    :func:`block_shuffle_ref`.  Returns (buffers, out_msg)."""
    buffers[_rows(buffers), recv_idx.long()] = msg
    return buffers, torch.where((recv_idx == send_idx)[:, None], msg, pre)


def block_acc_shuffle_ref(buffers: torch.Tensor, msg: torch.Tensor,
                          acc_idx: torch.Tensor, fwd_idx: torch.Tensor,
                          op: str = "sum"):
    """Fused accumulate+capture/drain, in place: accumulate msg into the
    acc slots, capture the fwd slots from the UPDATED buffer, then drain
    the fwd slots to the op identity.  Where ``acc == fwd`` the slot ends
    as the identity and the output is the combined value.  Returns
    (buffers, out_msg)."""
    rows, acc, fwd = _rows(buffers), acc_idx.long(), fwd_idx.long()
    buffers[rows, acc] = op_combine(op)(buffers[rows, acc], msg)
    out = buffers[rows, fwd]
    buffers[rows, fwd] = op_identity(op, buffers.dtype)
    return buffers, out


def block_acc_shuffle_staged_ref(buffers: torch.Tensor, msg: torch.Tensor,
                                 pre: torch.Tensor, acc_idx: torch.Tensor,
                                 fwd_idx: torch.Tensor, op: str = "sum"):
    """Overlap-staged accumulate+capture/drain: ``pre`` is the round-t+1
    fwd block packed from the PRE-update buffer.  Accumulate msg into the
    acc slots; the output is the combined value where ``fwd == acc`` and
    ``pre`` everywhere else; then the fwd slots drain to the identity --
    equal to :func:`block_acc_shuffle_ref`.  Returns (buffers, out_msg)."""
    rows, acc, fwd = _rows(buffers), acc_idx.long(), fwd_idx.long()
    combined = op_combine(op)(buffers[rows, acc], msg)
    buffers[rows, acc] = combined
    out = torch.where((acc_idx == fwd_idx)[:, None], combined, pre)
    buffers[rows, fwd] = op_identity(op, buffers.dtype)
    return buffers, out


def block_qacc_shuffle_ref(buffers: torch.Tensor, err: torch.Tensor,
                           qmsg: torch.Tensor, smsg: torch.Tensor,
                           acc_idx: torch.Tensor, fwd_idx: torch.Tensor):
    """Quantized accumulate+capture/drain (sum only), in place.

    ``buffers``/``err``: [R, nslots, bs] f32 partial sums and their
    accumulated requantization errors; ``qmsg`` [R, bs] int8 and
    ``smsg`` [R, nb] f32 the incoming blocks and their per-qb scales
    (bs == nb * qb).  Per row, in order: ``buffers[acc] = fma(q, s,
    buffers[acc])`` (one rounding, as the jitted reference); capture
    ``buffers[fwd]`` from the updated buffer and requantize it to
    ``(out_q, out_s)``; ``err[fwd] += captured - out_q*out_s`` (the
    error fused, the add a plain f32 add); drain ``buffers[fwd]`` to 0.
    Returns ``(buffers, err, out_q [R, bs] int8, out_s [R, nb] f32)``.
    """
    R, _, bs = buffers.shape
    nb = smsg.shape[1]
    qb = bs // nb
    rows, acc, fwd = _rows(buffers), acc_idx.long(), fwd_idx.long()
    cur = buffers[rows, acc].view(R, nb, qb)
    buffers[rows, acc] = fma_f32(cur, qmsg.view(R, nb, qb),
                                 smsg.view(R, nb, 1)).view(R, bs)
    captured = buffers[rows, fwd].view(R * nb, qb)
    q, s = quant_blocks(captured)
    eps = quant_error(captured, q, s).view(R, bs)
    err[rows, fwd] = err[rows, fwd] + eps
    buffers[rows, fwd] = 0
    return buffers, err, q.view(R, bs), s.view(R, nb)
