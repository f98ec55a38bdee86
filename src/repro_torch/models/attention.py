"""Grouped-query self-attention with RoPE, causal and sliding-window
masks, cross-attention to a memory, and multi-head latent attention.

Port of ``repro.models.attention``.
The full-sequence path (:func:`gqa_full`, train and prefill) and
cross-attention (:func:`cross_attn_apply`, the vlm and encdec families,
in prefill and in decode) run the hand-written CUDA flash attention on a
CUDA tensor (``backend="cuda"``, forward only: it refuses operands that
need a gradient) and otherwise :func:`blocked_attention`: the plain
blocked online softmax (also what the kernel's wrapper runs on a CPU
tensor) with the reference's O(S)-memory backward, an
``autograd.Function`` in place of its ``custom_vjp``.  Decode's
self-attention (:func:`gqa_decode`) attends a fixed-size cache with
position masks, in plain torch as in the reference.

Multi-head latent attention (:class:`MLA`, deepseek-v3) compresses keys
and values into a latent ``c_kv`` of ``kv_lora_rank`` plus one shared
RoPE key of ``qk_rope_dim``.  Its full-sequence path (:func:`mla_full`)
materializes per-head keys of ``qk_nope_dim + qk_rope_dim`` (192 in
deepseek-v3) and values of ``v_head_dim`` (128), and runs the same
kernel, whose tensor cores take that pair of widths; its decode
(:func:`mla_decode`) is the reference's absorbed form over the
compressed cache, plain torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import (
    NEG_INF,
    chunk_bounds,
    flash_attention,
    mask_for,
)
from ..kernels.flash_attention import blocked_attention as blocked_forward
from .common import ModelConfig
from .layers import apply_rope, dense_init, init_rms_norm, param, rms_norm

BACKENDS = ("cuda", "torch")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (use one of {BACKENDS})")


class GQA(nn.Module):
    """``wq`` [d, H*hd], ``wk``/``wv`` [d, Hkv*hd], ``wo`` [H*hd, d], and
    with ``cfg.qkv_bias`` the biases ``bq``, ``bk``, ``bv`` (zeros)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        hd, d = cfg.hd, cfg.d_model
        dev = device or gen.device
        self.wq = dense_init(gen, d, cfg.n_heads * hd, dtype, device=dev)
        self.wk = dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=dev)
        self.wv = dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=dev)
        self.wo = dense_init(gen, cfg.n_heads * hd, d, dtype, device=dev)
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = param(torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=dev))
            self.bk = param(torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=dev))
            self.bv = param(torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=dev))


class _BlockedAttention(torch.autograd.Function):
    """Blocked attention with the flash-attention backward: the forward is
    the plain blocked online softmax, which saves only (q, k, v, o, lse);
    the backward recomputes the scores chunk by chunk from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
        q_chunk, kv_chunk = min(q_chunk, q.shape[1]), min(kv_chunk, k.shape[1])
        out, lse = blocked_forward(q, k, v, causal, window, q_offset, q_chunk,
                                   kv_chunk, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, q_offset, q_chunk, kv_chunk = ctx.args
        B, Sq, H, hd = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        hd_v = v.shape[-1]
        rep = H // Hkv
        scale = 1.0 / math.sqrt(hd)
        n_q, n_kv = -(-Sq // q_chunk), -(-Skv // kv_chunk)
        dev = q.device

        def pad(t, chunks, size):
            return F.pad(t, (0, 0, 0, 0, 0, chunks * size - t.shape[1]))

        qp = pad(q, n_q, q_chunk).float()
        dop = pad(do, n_q, q_chunk).float()
        op = pad(o, n_q, q_chunk).float()
        kc = pad(k, n_kv, kv_chunk).float().view(B, n_kv, kv_chunk, Hkv, hd)
        vc = pad(v, n_kv, kv_chunk).float().view(B, n_kv, kv_chunk, Hkv, hd_v)
        dq = torch.zeros((B, n_q * q_chunk, Hkv, rep, hd), device=dev)
        dk = torch.zeros((B, n_kv, kv_chunk, Hkv, hd), device=dev)
        dv = torch.zeros((B, n_kv, kv_chunk, Hkv, hd_v), device=dev)
        for qi in range(n_q):
            sl = slice(qi * q_chunk, (qi + 1) * q_chunk)
            qb = qp[:, sl].reshape(B, q_chunk, Hkv, rep, hd)
            dob = dop[:, sl].reshape(B, q_chunk, Hkv, rep, hd_v)
            ob = op[:, sl].reshape(B, q_chunk, Hkv, rep, hd_v)
            lse_i = lse[qi]                                   # [B,Hkv,rep,qc]
            Dc = torch.einsum("bqhrd,bqhrd->bhrq", dob, ob)   # rowsum(do * o)
            q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
            lo, hi = chunk_bounds(qi, q_chunk, kv_chunk, n_kv, causal, window,
                                  q_offset)
            dq_i = torch.zeros((B, q_chunk, Hkv, rep, hd), device=dev)
            for j in range(lo, hi):
                kb, vb = kc[:, j], vc[:, j]
                kv_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
                s = torch.einsum("bqhrd,bkhd->bhrqk", qb, kb) * scale
                s = torch.where(mask_for(q_pos, kv_pos, causal, window, Skv), s,
                                NEG_INF)
                pr = torch.exp(s - lse_i[..., None])          # [B,Hkv,rep,qc,kc]
                dpv = torch.einsum("bqhrd,bkhd->bhrqk", dob, vb)
                ds = pr * (dpv - Dc[..., None]) * scale
                dq_i = dq_i + torch.einsum("bhrqk,bkhd->bqhrd", ds, kb)
                dk[:, j] += torch.einsum("bhrqk,bqhrd->bkhd", ds, qb)
                dv[:, j] += torch.einsum("bhrqk,bqhrd->bkhd", pr, dob)
            dq[:, sl] = dq_i
        dq = dq.reshape(B, n_q * q_chunk, H, hd)[:, :Sq].to(q.dtype)
        dk = dk.reshape(B, n_kv * kv_chunk, Hkv, hd)[:, :Skv].to(k.dtype)
        dv = dv.reshape(B, n_kv * kv_chunk, Hkv, hd_v)[:, :Skv].to(v.dtype)
        return dq, dk, dv, None, None, None, None, None


def blocked_attention(q, k, v, causal, window=None, q_offset=0,
                      q_chunk=1024, kv_chunk=1024):
    """Flash-style blocked attention with an O(S)-memory backward.

    q: [B, Sq, H, hd]; k/v: [B, Skv, Hkv, hd(_v)]; GQA head h attends kv
    head h // (H // Hkv).  Causal: q position i sees kv j iff
    j <= i + q_offset (and i + q_offset - j < window with a window).
    The backward recomputes the scores chunk by chunk from the saved
    (q, k, v, o, lse), the flash-attention recipe."""
    return _BlockedAttention.apply(q, k, v, causal, window, q_offset,
                                   q_chunk, kv_chunk)


def _project_qkv(p: GQA, x, cfg: ModelConfig, positions, rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.hd
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_full(p: GQA, x, cfg: ModelConfig, positions, *, causal=True,
             backend: str = "cuda"):
    """Train/prefill self-attention; returns ([B,S,d], (k, v) for caching).
    ``backend="cuda"`` runs the flash attention kernel on a CUDA tensor
    (its plain version on a CPU one; no backward); ``"torch"`` runs
    :func:`blocked_attention`, which trains."""
    check_backend(backend)
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if backend == "cuda":
        o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    else:
        o = blocked_attention(q, k, v, causal, cfg.sliding_window)
    o = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo
    return o, (k, v)


def write_rows(cache: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor) -> None:
    """``cache[b, pos[b]] = rows[b]`` in place, for every batch row b whose
    position lies in the cache; a write at ``pos >= cache.shape[1]`` is
    dropped, as JAX drops an out-of-range scatter (the reference's
    ``cache.at[bidx, pos].set``).  No host synchronisation."""
    B, S = cache.shape[:2]
    bidx = torch.arange(B, device=cache.device)
    inside = pos < S
    at = torch.where(inside, pos, S - 1)
    keep = cache[bidx, at]
    mask = inside.view(B, *([1] * (rows.dim() - 1)))
    cache[bidx, at] = torch.where(mask, rows.to(cache.dtype), keep)


def gqa_decode(p: GQA, x, cfg: ModelConfig, cache_k, cache_v, pos):
    """One-token decode.  x: [B, 1, d]; cache_[kv]: [B, S, Hkv, hd];
    pos: [B] per-slot positions (continuous batching) or a scalar.
    Writes the new key and value into the caches in place (dropped at
    ``pos >= S``) and returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    hd = cfg.hd
    S = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device).expand(B)
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    write_rows(cache_k, pos, k[:, 0])
    write_rows(cache_v, pos, v[:, 0])
    rep = cfg.n_heads // cfg.n_kv_heads
    qh = q.reshape(B, 1, cfg.n_kv_heads, rep, hd)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qh.float(), cache_k.float()) / math.sqrt(hd)
    idx = torch.arange(S, device=x.device)
    mask = idx[None, :] <= pos[:, None]                     # [B, S]
    if cfg.sliding_window is not None:
        mask = mask & (pos[:, None] - idx[None, :] < cfg.sliding_window)
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", w, cache_v.float())
    o = o.to(x.dtype).reshape(B, 1, cfg.n_heads * hd) @ p.wo
    return o, cache_k, cache_v


class CrossAttention(nn.Module):
    """``wq`` [d, H*hd], ``wk``/``wv`` [d, Hkv*hd] and ``wo`` [H*hd, d]."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        hd, d = cfg.hd, cfg.d_model
        dev = device or gen.device
        self.wq = dense_init(gen, d, cfg.n_heads * hd, dtype, device=dev)
        self.wk = dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=dev)
        self.wv = dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device=dev)
        self.wo = dense_init(gen, cfg.n_heads * hd, d, dtype, device=dev)


def cross_attn_apply(p: CrossAttention, x, memory, cfg: ModelConfig, *,
                     backend: str = "cuda"):
    """x: [B, S, d] queries; memory: [B, T, d] keys and values (no
    RoPE, no mask: every query sees all T rows) -> [B, S, d].
    ``backend="cuda"`` runs the flash attention kernel on a CUDA tensor
    (its plain version on a CPU one); ``"torch"`` runs
    :func:`blocked_attention`, which trains."""
    check_backend(backend)
    B, S, _ = x.shape
    T = memory.shape[1]
    hd = cfg.hd
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, hd)
    k = (memory @ p.wk).reshape(B, T, cfg.n_kv_heads, hd)
    v = (memory @ p.wv).reshape(B, T, cfg.n_kv_heads, hd)
    if backend == "cuda":
        o = flash_attention(q, k, v, causal=False)
    else:
        o = blocked_attention(q, k, v, False)
    return o.reshape(B, S, cfg.n_heads * hd) @ p.wo


# ------------------------------------------------------------------ MLA


class MLA(nn.Module):
    """Multi-head latent attention: ``w_dq`` [d, q_lora], ``q_norm``
    [q_lora] f32, ``w_uq`` [q_lora, H*(nope+rope)], ``w_dkv`` [d, kv_lora],
    ``kv_norm`` [kv_lora] f32, ``w_kr`` [d, rope], ``w_uk`` [kv_lora,
    H*nope], ``w_uv`` [kv_lora, H*v] and ``wo`` [H*v, d]."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
        dev = device or gen.device
        self.w_dq = dense_init(gen, d, m.q_lora_rank, dtype, device=dev)
        self.q_norm = init_rms_norm(m.q_lora_rank, dev)
        self.w_uq = dense_init(gen, m.q_lora_rank, H * (m.qk_nope_dim + m.qk_rope_dim),
                               dtype, device=dev)
        self.w_dkv = dense_init(gen, d, m.kv_lora_rank, dtype, device=dev)
        self.kv_norm = init_rms_norm(m.kv_lora_rank, dev)
        self.w_kr = dense_init(gen, d, m.qk_rope_dim, dtype, device=dev)
        self.w_uk = dense_init(gen, m.kv_lora_rank, H * m.qk_nope_dim, dtype, device=dev)
        self.w_uv = dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dtype, device=dev)
        self.wo = dense_init(gen, H * m.v_head_dim, d, dtype, device=dev)


def _mla_q(p: MLA, x, cfg: ModelConfig, positions):
    """The queries' (nope, rope) parts, [B, S, H, nope] and [B, S, H, rope],
    the rope part rotated."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rms_norm(x @ p.w_dq, p.q_norm, cfg.norm_eps)
    qall = (cq @ p.w_uq).reshape(B, S, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = qall[..., :m.qk_nope_dim], qall[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p: MLA, x, cfg: ModelConfig, positions):
    """What the cache holds of x: the normed latent ``c_kv`` [B, S, kv_lora]
    and the rotated shared key ``k_rope`` [B, S, 1, rope]."""
    c_kv = rms_norm(x @ p.w_dkv, p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope((x @ p.w_kr)[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_full(p: MLA, x, cfg: ModelConfig, positions, *, causal=True,
             backend: str = "cuda"):
    """Materialized MLA for train and prefill -> ([B, S, d], (c_kv, k_rope)
    for the cache, [B, S, kv_lora] and [B, S, rope]).  q and k are
    ``cat(nope, rope)`` per head (the rope key shared by every head), v is
    ``c_kv @ w_uv``; ``backend`` as :func:`gqa_full`'s."""
    check_backend(backend)
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = (c_kv @ p.w_uk).reshape(B, S, H, m.qk_nope_dim)
    v = (c_kv @ p.w_uv).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    if backend == "cuda":
        o = flash_attention(q, k, v, causal=causal)
    else:
        o = blocked_attention(q, k, v, causal)
    o = o.reshape(B, S, H * m.v_head_dim) @ p.wo
    return o, (c_kv, k_rope[:, :, 0])


def mla_decode(p: MLA, x, cfg: ModelConfig, cache_ckv, cache_kr, pos):
    """One-token MLA decode in the absorbed form, over the compressed
    cache: cache_ckv [B, S, kv_lora], cache_kr [B, S, rope].  Scores are
    taken in latent space (``q_nope`` absorbs ``w_uk``, the output
    absorbs ``w_uv``), so no per-head key or value is made.  Writes the
    new rows in place (dropped at ``pos >= S``) and returns (out,
    cache_ckv, cache_kr).  Types as the reference's: the absorbed query
    in x's dtype, both score products and the weighted latent sum in
    f32, the latent output cast to x's dtype before ``w_uv``."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    S = cache_ckv.shape[1]
    pos = torch.as_tensor(pos, device=x.device).expand(B)
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)             # [B, 1, H, *]
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    write_rows(cache_ckv, pos, c_kv[:, 0])
    write_rows(cache_kr, pos, k_rope[:, 0, 0])
    w_uk = p.w_uk.reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)      # absorb w_uk
    s = torch.einsum("bqhr,bkr->bhqk", q_lat.float(), cache_ckv.float())
    s = s + torch.einsum("bqhn,bkn->bhqk", q_rope.float(), cache_kr.float())
    s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]   # [B, S]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", w, cache_ckv.float())
    w_uv = p.w_uv.reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat.to(x.dtype), w_uv)
    o = o.reshape(B, 1, H * m.v_head_dim) @ p.wo
    return o, cache_ckv, cache_kr
