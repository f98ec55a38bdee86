"""Grouped-query self-attention with RoPE, causal and sliding-window masks.

Port of the GQA half of ``repro.models.attention``.  The full-sequence
path (:func:`gqa_full`, train and prefill) runs the hand-written CUDA
flash attention on a CUDA tensor (``backend="cuda"``) and the plain
blocked online softmax otherwise (:func:`blocked_attention`, also what
the kernel's wrapper runs on a CPU tensor).  Decode (:func:`gqa_decode`)
attends a fixed-size cache with position masks, in plain torch as in the
reference.  Cross-attention (vlm, encdec) and MLA (moe) wait for a later
slice (``ROADMAP.md``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.flash_attention import NEG_INF, blocked_attention, flash_attention
from .common import ModelConfig
from .layers import apply_rope, dense_init, param

BACKENDS = ("cuda", "torch")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (use one of {BACKENDS})")


class GQA(nn.Module):
    """``wq`` [d, H*hd], ``wk``/``wv`` [d, Hkv*hd], ``wo`` [H*hd, d], and
    with ``cfg.qkv_bias`` the biases ``bq``, ``bk``, ``bv`` (zeros)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, dtype):
        super().__init__()
        hd, d = cfg.hd, cfg.d_model
        self.wq = dense_init(gen, d, cfg.n_heads * hd, dtype)
        self.wk = dense_init(gen, d, cfg.n_kv_heads * hd, dtype)
        self.wv = dense_init(gen, d, cfg.n_kv_heads * hd, dtype)
        self.wo = dense_init(gen, cfg.n_heads * hd, d, dtype)
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            dev = gen.device
            self.bq = param(torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=dev))
            self.bk = param(torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=dev))
            self.bv = param(torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype, device=dev))


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
    (its plain version on a CPU one); ``"torch"`` the plain version."""
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
