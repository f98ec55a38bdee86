"""Forward flash attention: the checked, counted wrapper of the CUDA kernel
and its plain version.

Port of the TPU kernel ``repro.kernels.flash_attention.flash_attention``
with its GQA wrapper ``repro.kernels.ops.gqa_flash_attention``; the kernel
is ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a, built by
:mod:`repro_torch.kernels._build` at the first launch).

:func:`flash_attention` keeps the wrapper's layout: q ``[B, Sq, H, hd]``,
k/v ``[B, Skv, Hkv, hd(_v)]`` -> ``[B, Sq, H, hd_v]`` in q's dtype, with
query head h reading kv head ``h // (H // Hkv)``.  On CPU tensors (and
on ``meta`` ones, which hold no data for a kernel: the dry run) it runs
:func:`blocked_attention`, the plain version (the forward of
``repro.models.attention.blocked_attention``: the same online softmax in
f32 over key chunks); on CUDA tensors it launches the kernel, adds one to
:data:`LAUNCHES` (and to its shape's count in :data:`LAUNCHES_BY_SHAPE`),
and raises if the launch failed.  There is no fallback from a CUDA tensor
to the plain version.  The kernel has no backward: on
the card an operand that requires grad under grad mode raises
``ValueError`` (the plain version on a CPU tensor keeps autograd).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES = {"flash_attention": 0}
#: The same launches by shape: (causal, Sq, Skv, H, Hkv, hd) -> launches.
LAUNCHES_BY_SHAPE: dict = {}

#: Element types the kernel reads and writes, by the code it switches on.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: The widest v head the kernel's instances cover (stablelm-12b's 160); a
#: wider one is refused on every device, so no CPU run passes on a width
#: the card refuses.
MAX_HEAD_DIM_V = 160
NEG_INF = -1e30


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0
    LAUNCHES_BY_SHAPE.clear()


def chunk_bounds(qi, q_chunk, kv_chunk, n_kv, causal, window, q_offset):
    """The [lo, hi) kv-chunk range visited by q chunk qi."""
    if causal:
        last_q = q_offset + (qi + 1) * q_chunk - 1
        hi = min(n_kv, last_q // kv_chunk + 1)
    else:
        hi = n_kv
    if window is not None and causal:
        first_q = q_offset + qi * q_chunk
        lo = max(0, (first_q - window + 1) // kv_chunk)
    else:
        lo = 0
    return lo, max(hi, lo + 1)


def mask_for(q_pos, kv_pos, causal, window, skv_true):
    """[len(q_pos), len(kv_pos)] bool: which keys each query sees."""
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    else:
        mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    if window is not None and causal:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < window)
    return mask & (kv_pos < skv_true)[None, :]


def _pad_seq(t: torch.Tensor, length: int) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, 0, 0, length - t.shape[1]))


def blocked_attention(q, k, v, causal, window=None, q_offset=0,
                      q_chunk=1024, kv_chunk=1024, with_lse=False):
    """Plain blocked attention, forward only.

    q: [B, Sq, H, hd]; k/v: [B, Skv, Hkv, hd(_v)]; GQA head h attends kv
    head h // (H // Hkv).  Causal: q position i sees kv j iff
    j <= i + q_offset (and i + q_offset - j < window with a window).
    Online softmax in f32 over kv chunks (masked scores -1e30, ``l``
    clamped at 1e-30), never the whole S x S; returns q's dtype, and with
    ``with_lse`` also the f32 log-sum-exp of each q chunk's scores,
    ``[n_q, B, Hkv, rep, q_chunk]`` (what the backward recomputes from).
    """
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    rep = H // Hkv
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    scale = 1.0 / math.sqrt(hd)
    n_q = -(-Sq // q_chunk)
    n_kv = -(-Skv // kv_chunk)
    qp = _pad_seq(q.float(), n_q * q_chunk)
    kc = _pad_seq(k.float(), n_kv * kv_chunk).view(B, n_kv, kv_chunk, Hkv, hd)
    vc = _pad_seq(v.float(), n_kv * kv_chunk).view(B, n_kv, kv_chunk, Hkv, hd_v)
    dev = q.device
    outs, lses = [], []
    for qi in range(n_q):
        qb = qp[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(B, q_chunk, Hkv, rep, hd)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        lo, hi = chunk_bounds(qi, q_chunk, kv_chunk, n_kv, causal, window, q_offset)
        m = torch.full((B, Hkv, rep, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, rep, q_chunk), device=dev)
        acc = torch.zeros((B, Hkv, rep, q_chunk, hd_v), device=dev)
        for j in range(lo, hi):
            kv_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhrd,bkhd->bhrqk", qb, kc[:, j]) * scale
            s = torch.where(mask_for(q_pos, kv_pos, causal, window, Skv), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pz = torch.exp(s - m_new[..., None])
            l = l * alpha + pz.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", pz, vc[:, j])
            m = m_new
        safe_l = l.clamp_min(1e-30)
        ob = (acc / safe_l[..., None]).to(q.dtype)
        outs.append(ob.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd_v))
        lses.append(m + torch.log(safe_l))
    out = torch.cat(outs, dim=1)[:, :Sq]
    return (out, torch.stack(lses)) if with_lse else out


def _check(q, k, v, window) -> bool:
    """Validate the operands; True when they lie on a CUDA device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, heads, head_dim]")
    B, _, H, hd = q.shape
    Bk, Skv, Hkv, hdk = k.shape
    if (Bk, Skv, Hkv) != tuple(v.shape[:3]) or Bk != B or hdk != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not fit together")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} kv heads")
    if min(q.shape) < 1 or Skv < 1 or v.shape[3] < 1:
        raise ValueError("empty attention operands")
    if v.shape[3] > MAX_HEAD_DIM_V:
        raise ValueError(f"hd_v {v.shape[3]} > {MAX_HEAD_DIM_V}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {sorted(map(str, DTYPES))}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cuda"


def refuse_grad(name: str, *operands) -> None:
    """The kernels compute a forward only: an operand that needs a
    gradient under grad mode is refused, not given a result without one
    (the kernel writes its output outside autograd)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise ValueError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            "tensors that need no gradient, and train through the plain "
            "version (backend='torch')")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of q [B, Sq, H, hd] over k/v [B, Skv, Hkv, hd(_v)] ->
    [B, Sq, H, hd_v] in q's dtype (f32 inside).  ``window`` (with
    ``causal``) limits query i to keys i - window < j <= i."""
    if not _check(q, k, v, window):
        return blocked_attention(q, k, v, causal, window)
    refuse_grad("flash_attention", q, k, v)
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    from . import _build

    B, Sq, H, hd = q.shape
    Skv, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    _build.launch("flash_attention", "flash_attention", q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Skv, H, Hkv, hd, hd_v, Skv, int(causal),
                  window if (causal and window is not None) else 0,
                  DTYPES[q.dtype])
    LAUNCHES["flash_attention"] += 1
    shape = (bool(causal), Sq, Skv, H, Hkv, hd)
    LAUNCHES_BY_SHAPE[shape] = LAUNCHES_BY_SHAPE.get(shape, 0) + 1
    return out
