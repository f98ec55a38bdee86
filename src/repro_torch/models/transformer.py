"""LM assembly for the dense, ssm, hybrid, vlm, encdec and moe families.

Port of ``repro.models.transformer`` (serving, and the training loss
with remat).  A model is a repeated *super-block pattern* over R
repeats:

  dense        ['attn']            x n_layers
  ssm          ['ssm']             x n_layers     (mamba2)
  hybrid       ['ssm']*k + shared-attn call       (zamba2: one SHARED
               weight set applied after every k mamba layers)
  vlm          ['attn']*(k-1) + ['xattn']         (llama-3.2-vision:
               gated cross-attention to the image memory every k-th layer)
  encdec       encoder ['enc'] x encoder_layers;
               decoder ['dec'] (self-attn + cross-attn) x n_layers
               (whisper)
  moe          ['attn_moe']        x n_layers     (deepseek-moe: GQA,
               then a mixture of experts in place of the MLP, :mod:`.moe`)
  moe + MLA    ['mla_moe']         x n_layers     (deepseek-v3: multi-head
               latent attention, then the mixture of experts)

The vlm and encdec families read a *memory*: the stub frontend's image
or audio embeddings ``memory_embeds`` [B, T, d], projected by
``img_proj`` (vlm) or run through the encoder stack (encdec,
:func:`encode_memory`).  A decode cache holds it under ``"memory"`` as
given, and each step projects a vlm memory again, as the reference does.

The reference stacks each pattern position's parameters over R and scans
them; here they are ``R * len(pattern)`` layer modules in execution order
(:attr:`Model.layers`, layer ``r * len(pattern) + i`` is position i of
repeat r), and the shared block is :attr:`Model.shared_attn`.  Decode
caches stay stacked ``[R, B, ...]`` per pattern position, as in the
reference, and :func:`decode_step` updates them in place.  The trainer
keeps the parameters in the reference's stacked layout and binds views
of them into a model (:mod:`repro_torch.models.convert`); :func:`loss_fn`
differentiates through them, with each super-block checkpointed
(``remat="full"``) or its matrix products saved (``"dots"``).  Each
``attn_moe`` and ``mla_moe`` layer adds its load-balancing loss to the
aux sum that :func:`forward_hidden` returns and :func:`loss_fn` weighs
by 0.01.  An ``mla_moe`` layer's decode cache is the compressed one,
``c_kv`` and the shared RoPE key.  With ``cfg.mtp`` (deepseek-v3) the
model also holds the depth-1 multi-token-prediction block ``mtp`` and
its input projection ``mtp_proj``, which only :func:`loss_fn` uses.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..core.comm import resolve_device
from .attention import (
    GQA,
    MLA,
    CrossAttention,
    check_backend,
    cross_attn_apply,
    gqa_decode,
    gqa_full,
    mla_decode,
    mla_full,
)
from .common import ModelConfig
from .layers import (
    GeluMLP,
    SwiGLU,
    chunked_softmax_xent,
    embed_apply,
    embed_init,
    gelu_mlp_apply,
    init_rms_norm,
    param,
    rms_norm,
    swiglu_apply,
    unembed_apply,
)
from .moe import MoE, moe_apply
from .ssm import Mamba2, ssm_block

# ------------------------------------------------------------- patterns


def layer_pattern(cfg: ModelConfig) -> Tuple[List[str], int, bool]:
    """Returns (pattern, repeats, has_shared_block)."""
    if cfg.family == "dense":
        return ["attn"], cfg.n_layers, False
    if cfg.family == "ssm":
        return ["ssm"], cfg.n_layers, False
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every or 6
        if cfg.n_layers % k:
            raise ValueError("hybrid layers must divide shared_attn_every")
        return ["ssm"] * k, cfg.n_layers // k, True
    if cfg.family == "vlm":
        k = cfg.cross_attn_every or 5
        if cfg.n_layers % k:
            raise ValueError("vlm layers must divide cross_attn_every")
        return ["attn"] * (k - 1) + ["xattn"], cfg.n_layers // k, False
    if cfg.family == "encdec":
        return ["dec"], cfg.n_layers, False
    if cfg.family == "moe":
        return ["mla_moe" if cfg.mla is not None else "attn_moe"], cfg.n_layers, False
    raise ValueError(cfg.family)


#: The families whose forward pass and decode read a memory.
MEMORY_FAMILIES = ("vlm", "encdec")
#: The layers whose MLP is a mixture of experts.
MOE_LAYERS = ("attn_moe", "mla_moe")


# ---------------------------------------------------------------- init


class Block(nn.Module):
    """One layer, with the reference's parameter names: ``attn`` and
    ``enc`` (``ln1``, ``attn``, ``ln2``, ``mlp``: SwiGLU, or GELU in the
    encoder), ``attn_moe`` and ``mla_moe`` (``ln1``, ``attn``: GQA or
    MLA, ``ln2``, ``moe``), ``ssm`` (``ln1``, ``ssm``), ``xattn``
    (``ln1``, ``xattn``, ``gate`` [1] f32 zeros, ``ln2``, a SwiGLU
    ``mlp``) or ``dec`` (``ln1``, ``attn``, ``lnx``, ``xattn``, ``ln2``,
    a GELU ``mlp``)."""

    def __init__(self, gen: torch.Generator, typ: str, cfg: ModelConfig, dtype,
                 device=None):
        super().__init__()
        self.typ = typ
        d, dev = cfg.d_model, device or gen.device
        self.ln1 = init_rms_norm(d, dev)
        if typ == "ssm":
            self.ssm = Mamba2(gen, cfg, dtype, dev)
            return
        if typ in ("attn", "enc", "dec", "attn_moe"):
            self.attn = GQA(gen, cfg, dtype, dev)
        elif typ == "mla_moe":
            self.attn = MLA(gen, cfg, dtype, dev)
        elif typ != "xattn":
            raise ValueError(typ)
        if typ == "dec":
            self.lnx = init_rms_norm(d, dev)
        if typ in ("xattn", "dec"):
            self.xattn = CrossAttention(gen, cfg, dtype, dev)
        if typ == "xattn":
            self.gate = param(torch.zeros((1,), dtype=torch.float32, device=dev))
        self.ln2 = init_rms_norm(d, dev)
        if typ in MOE_LAYERS:
            self.moe = MoE(gen, cfg, dtype, dev)
            return
        mlp = GeluMLP if typ in ("enc", "dec") else SwiGLU
        self.mlp = mlp(gen, d, cfg.d_ff, dtype, dev)


class Model(nn.Module):
    """``embed`` [V, d], ``ln_f``, ``unembed`` [V, d] (None when tied), the
    layers in execution order, the hybrid family's ``shared_attn``, the
    encdec family's encoder ``enc`` (``encoder_layers`` blocks) and
    ``enc_ln_f``, the vlm family's ``img_proj`` [d, d], and with
    ``cfg.mtp`` the ``attn`` block ``mtp`` and ``mtp_proj`` [2d, d]."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        dtype = cfg.torch_dtype
        dev = device or gen.device
        pattern, R, shared = layer_pattern(cfg)
        self.embed = embed_init(gen, cfg.vocab, cfg.d_model, dtype, dev)
        self.ln_f = init_rms_norm(cfg.d_model, dev)
        self.unembed = None if cfg.tie_embeddings else embed_init(
            gen, cfg.vocab, cfg.d_model, dtype, dev)
        self.layers = nn.ModuleList(
            Block(gen, typ, cfg, dtype, dev) for _ in range(R) for typ in pattern)
        self.shared_attn = Block(gen, "attn", cfg, dtype, dev) if shared else None
        self.enc = self.enc_ln_f = self.img_proj = None
        if cfg.family == "encdec":
            self.enc = nn.ModuleList(
                Block(gen, "enc", cfg, dtype, dev) for _ in range(cfg.encoder_layers))
            self.enc_ln_f = init_rms_norm(cfg.d_model, dev)
        if cfg.family == "vlm":
            self.img_proj = embed_init(gen, cfg.d_model, cfg.d_model, dtype, dev)
        self.mtp = self.mtp_proj = None
        if cfg.mtp:
            self.mtp = Block(gen, "attn", cfg, dtype, dev)
            self.mtp_proj = embed_init(gen, 2 * cfg.d_model, cfg.d_model, dtype, dev)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
                device=None) -> Model:
    """Random parameters on ``device`` (``None``: the card) from
    ``generator`` (default: seed 0 on that device), as the reference's
    ``init_params`` lays them out.  Same shapes and dtypes as the
    reference's (norms and ``A_log``/``D``/``dt_bias`` in f32, the rest in
    the config's dtype); the numbers differ (another generator).
    ``device="meta"`` builds the structure with no storage."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return Model(cfg, torch.Generator(), dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}")
    return Model(cfg, generator)


def _table(params: Model) -> torch.Tensor:
    return params.embed if params.unembed is None else params.unembed


# ------------------------------------------------------------- forward


def _mlp_apply(p: Block, x):
    mlp = gelu_mlp_apply if isinstance(p.mlp, GeluMLP) else swiglu_apply
    return mlp(p.mlp, x)


def _gated_cross(p: Block, x, memory, cfg: ModelConfig, backend: str):
    """The ``xattn`` layer's body: ``tanh(gate)``-scaled cross-attention,
    then its MLP."""
    h = cross_attn_apply(p.xattn, rms_norm(x, p.ln1, cfg.norm_eps), memory, cfg,
                         backend=backend)
    x = x + torch.tanh(p.gate).to(x.dtype) * h
    return x + _mlp_apply(p, rms_norm(x, p.ln2, cfg.norm_eps))


def _apply_layer(p: Block, x, cfg: ModelConfig, positions, memory, backend: str):
    """One layer over the whole sequence -> (x, the layer's aux loss: a
    tensor for ``attn_moe`` and ``mla_moe``, else None)."""
    if p.typ == "ssm":
        return x + ssm_block(p.ssm, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                             backend=backend), None
    if p.typ == "xattn":
        return _gated_cross(p, x, memory, cfg, backend), None
    attn = mla_full if p.typ == "mla_moe" else gqa_full
    h, _ = attn(p.attn, rms_norm(x, p.ln1, cfg.norm_eps), cfg, positions,
                causal=p.typ != "enc", backend=backend)
    x = x + h
    if p.typ in MOE_LAYERS:
        h, aux = moe_apply(p.moe, rms_norm(x, p.ln2, cfg.norm_eps), cfg)
        return x + h, aux
    if p.typ == "dec":
        x = x + cross_attn_apply(p.xattn, rms_norm(x, p.lnx, cfg.norm_eps), memory,
                                 cfg, backend=backend)
    return x + _mlp_apply(p, rms_norm(x, p.ln2, cfg.norm_eps)), None


def _encode(params: Model, cfg: ModelConfig, audio_embeds, backend: str):
    """The encoder stack over stub frame embeddings [B, T, d]: non-causal
    self-attention with RoPE and a GELU MLP a layer, then ``enc_ln_f``."""
    x = audio_embeds.to(cfg.torch_dtype)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    for p in params.enc:
        x, _ = _apply_layer(p, x, cfg, positions, None, backend)
    return rms_norm(x, params.enc_ln_f, cfg.norm_eps)


def encode_memory(params: Model, cfg: ModelConfig, memory_embeds):
    """The memory as a decode cache stores it (``init_cache(memory=)``):
    the encoder's output for encdec, the embeddings as given for vlm
    (:func:`decode_step` projects them through ``img_proj`` each step)."""
    if cfg.family == "encdec":
        return _encode(params, cfg, memory_embeds, "cuda")
    return memory_embeds


def _require_memory(cfg: ModelConfig, memory, what: str) -> None:
    if cfg.family in MEMORY_FAMILIES and memory is None:
        raise ValueError(f"the {cfg.family} family reads a memory: {what}")


def _memory(params: Model, cfg: ModelConfig, memory_embeds, backend: str):
    """The memory the decoder's cross-attention reads, from the stub
    frontend's embeddings (None for the families without one)."""
    _require_memory(cfg, memory_embeds, "pass memory_embeds [B, T, d]")
    if cfg.family == "vlm":
        return memory_embeds.to(cfg.torch_dtype) @ params.img_proj
    if cfg.family == "encdec":
        return _encode(params, cfg, memory_embeds, backend)
    return None


#: The matrix products ``remat="dots"`` keeps (the reference's
#: ``checkpoint_dots_with_no_batch_dims``: a product with no batch
#: dimensions; attention's batched einsums and the experts' batched
#: products are recomputed).
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMATS = ("none", "full", "dots")


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward_hidden(params: Model, cfg: ModelConfig, tokens, *,
                   memory_embeds=None, backend: str = "cuda",
                   remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward: tokens [B, S] -> (hidden [B, S, d], aux_loss):
    the f32 sum of the moe layers' load-balancing losses (0 without
    them).
    ``memory_embeds`` [B, T, d]: the stub frontend's image (vlm) or audio
    frame (encdec) embeddings, which those families need.
    ``backend="cuda"`` runs attention and the SSD scan in the CUDA kernels
    on a CUDA tensor; ``"torch"`` runs their plain versions (the training
    path).  ``remat``: ``"none"``; ``"full"`` checkpoints each super-block
    (its backward recomputes it from its input); ``"dots"`` keeps the
    matrix products' outputs and recomputes the rest."""
    check_backend(backend)
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r} (use one of {REMATS})")
    pattern, R, shared = layer_pattern(cfg)
    B, S = tokens.shape
    x = embed_apply(params.embed, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    memory = _memory(params, cfg, memory_embeds, backend)
    k = len(pattern)

    def super_block(x, aux, r):
        for i in range(k):
            x, a = _apply_layer(params.layers[r * k + i], x, cfg, positions, memory,
                                backend)
            if a is not None:
                aux = aux + a
        if shared:
            x, _ = _apply_layer(params.shared_attn, x, cfg, positions, None, backend)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(R):
        if remat == "none":
            x, aux = super_block(x, aux, r)
            continue
        # a recomputed moe layer routes as its first pass did: its sorts
        # are stable, so equal inputs give equal slots
        kw = {} if remat == "full" else {"context_fn": partial(
            create_selective_checkpoint_contexts, _save_products)}
        x, aux = checkpoint(super_block, x, aux, r, use_reentrant=False, **kw)
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    return x, aux


def forward(params: Model, cfg: ModelConfig, tokens, *, memory_embeds=None,
            backend: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: tokens [B, S] -> (logits [B, S, V], aux_loss)."""
    x, aux = forward_hidden(params, cfg, tokens, memory_embeds=memory_embeds,
                            backend=backend)
    return unembed_apply(_table(params), x), aux


def loss_fn(params: Model, cfg: ModelConfig, batch, *, remat: str = "none",
            backend: str = "torch"):
    """The training loss of ``batch`` ({"tokens", "labels"}, [B, S] each;
    label -100 is ignored; "memory_embeds" for the vlm and encdec
    families): ``(ce + 0.01 * aux, {"ce", "aux"})``, the cross entropy
    through the chunked LM head.  With ``cfg.mtp`` the loss adds 0.3 x
    the depth-1 multi-token-prediction term, ``metrics["mtp"]``: the
    ``mtp`` block, run on ``mtp_proj`` of the final hidden state beside
    the next token's embedding (each through ``ln_f`` again, as the
    reference does), predicts the token after next.
    ``backend="torch"`` (the default) differentiates; the CUDA kernels
    have no backward."""
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = forward_hidden(params, cfg, tokens,
                                 memory_embeds=batch.get("memory_embeds"),
                                 backend=backend, remat=remat)
    table = _table(params)
    loss = chunked_softmax_xent(hidden, table, labels)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp:
        B, S = tokens.shape
        emb_next = embed_apply(params.embed, F.pad(tokens[:, 1:], (0, 1)))
        h_in = torch.cat([rms_norm(hidden, params.ln_f, cfg.norm_eps),
                          rms_norm(emb_next, params.ln_f, cfg.norm_eps)],
                         dim=-1) @ params.mtp_proj
        positions = torch.arange(S, device=hidden.device).expand(B, S)
        h_mtp, _ = _apply_layer(params.mtp, h_in, cfg, positions, None, backend)
        labels_mtp = F.pad(labels[:, 1:], (0, 1), value=-100)
        mtp_loss = chunked_softmax_xent(h_mtp, table, labels_mtp)
        loss = loss + 0.3 * mtp_loss
        metrics["mtp"] = mtp_loss
    return loss + 0.01 * aux, metrics


def prefill(params: Model, cfg: ModelConfig, tokens, *, memory_embeds=None,
            backend: str = "cuda") -> torch.Tensor:
    """Prefill: full backbone forward, unembed ONLY the last position
    (no [B, S, V] logits for long prompts) -> [B, 1, V]."""
    hidden, _ = forward_hidden(params, cfg, tokens, memory_embeds=memory_embeds,
                               backend=backend)
    return unembed_apply(_table(params), hidden[:, -1:])


# ---------------------------------------------------------------- cache


def init_cache(cfg: ModelConfig, batch: int, seq: int, *, memory=None,
               device=None) -> Dict[str, torch.Tensor]:
    """Decode cache, stacked [R, ...] per pattern position: ``pos{i}_k`` /
    ``pos{i}_v`` [R, B, seq, Hkv, hd] (``attn``, ``attn_moe``, ``dec``),
    ``pos{i}_ckv`` [R, B, seq, kv_lora] and ``pos{i}_kr`` [R, B, seq, rope]
    (``mla_moe``: the compressed latent and the shared RoPE key),
    ``pos{i}_conv`` [R, B, d_conv-1, channels] and ``pos{i}_ssd``
    [R, B, H, N, P] f32 (ssm), nothing for ``xattn``, ``shared_k``/
    ``shared_v`` (hybrid), ``pos_idx`` [B] int32, each slot's next
    position (continuous batching), and ``memory`` as given (the
    :func:`encode_memory` of the frontend's embeddings), which the vlm
    and encdec families' decode reads."""
    dev = resolve_device(device)
    pattern, R, shared = layer_pattern(cfg)
    dtype = cfg.torch_dtype
    s = cfg.ssm

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def kv():
        return zeros((R, batch, seq, cfg.n_kv_heads, cfg.hd))

    cache = {"pos_idx": zeros((batch,), torch.int32)}
    for i, typ in enumerate(pattern):
        if typ in ("attn", "attn_moe", "dec"):
            cache[f"pos{i}_k"], cache[f"pos{i}_v"] = kv(), kv()
        elif typ == "mla_moe":
            cache[f"pos{i}_ckv"] = zeros((R, batch, seq, cfg.mla.kv_lora_rank))
            cache[f"pos{i}_kr"] = zeros((R, batch, seq, cfg.mla.qk_rope_dim))
        elif typ == "ssm":
            d_in = s.expand * cfg.d_model
            cch = d_in + 2 * s.n_groups * s.d_state
            cache[f"pos{i}_conv"] = zeros((R, batch, s.d_conv - 1, cch))
            cache[f"pos{i}_ssd"] = zeros(
                (R, batch, d_in // s.head_dim, s.d_state, s.head_dim), torch.float32)
    if shared:
        cache["shared_k"], cache["shared_v"] = kv(), kv()
    if memory is not None:
        cache["memory"] = memory
    return cache


def _decode_layer(p: Block, x, cfg: ModelConfig, cache, prefix: str, r: int, pos,
                  memory):
    """One-token decode through one layer, its cache rows updated in place.
    Cross-attention runs the flash attention kernel on a CUDA tensor.  A
    moe layer routes the step's B tokens together: its capacity follows
    B, and the slots compete for it.  An ``mla_moe`` layer attends its
    compressed cache in the absorbed form."""
    if p.typ == "ssm":
        y, _, _ = ssm_block(p.ssm, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                            conv_state=cache[f"{prefix}_conv"][r],
                            ssd_state=cache[f"{prefix}_ssd"][r])
        return x + y
    if p.typ == "xattn":
        return _gated_cross(p, x, memory, cfg, "cuda")
    if p.typ == "mla_moe":
        h, _, _ = mla_decode(p.attn, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                             cache[f"{prefix}_ckv"][r], cache[f"{prefix}_kr"][r], pos)
    else:
        h, _, _ = gqa_decode(p.attn, rms_norm(x, p.ln1, cfg.norm_eps), cfg,
                             cache[f"{prefix}_k"][r], cache[f"{prefix}_v"][r], pos)
    x = x + h
    if p.typ in MOE_LAYERS:
        h, _ = moe_apply(p.moe, rms_norm(x, p.ln2, cfg.norm_eps), cfg)
        return x + h
    if p.typ == "dec":
        x = x + cross_attn_apply(p.xattn, rms_norm(x, p.lnx, cfg.norm_eps), memory,
                                 cfg)
    return x + _mlp_apply(p, rms_norm(x, p.ln2, cfg.norm_eps))


def decode_step(params: Model, cfg: ModelConfig, cache, tokens):
    """One decoding step.  tokens: [B, 1] -> (logits [B, 1, V], cache):
    the cache's tensors are updated in place (a key or value at
    ``pos >= seq`` is dropped) and ``pos_idx`` advances by one.  A vlm or
    encdec cache must hold ``"memory"`` (``init_cache(memory=)``): without
    it this raises ``ValueError`` (the reference fails on ``None``)."""
    pattern, R, shared = layer_pattern(cfg)
    pos = cache["pos_idx"]
    memory = cache.get("memory")
    _require_memory(cfg, memory, 'the cache has no "memory": build it with '
                    "init_cache(cfg, batch, seq, memory=encode_memory(...))")
    if cfg.family == "vlm":
        memory = memory.to(cfg.torch_dtype) @ params.img_proj
    x = embed_apply(params.embed, tokens)
    k = len(pattern)
    for r in range(R):
        for i in range(k):
            x = _decode_layer(params.layers[r * k + i], x, cfg, cache, f"pos{i}", r,
                              pos, memory)
        if shared:
            x = _decode_layer(params.shared_attn, x, cfg, cache, "shared", r, pos,
                              None)
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    cache["pos_idx"] = pos + 1
    return unembed_apply(_table(params), x), cache
