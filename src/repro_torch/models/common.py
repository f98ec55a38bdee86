"""Model configuration dataclasses shared by every architecture family.

Port of ``repro.models.common``: the same fields, defaults and analytic
parameter counts; ``torch_dtype`` takes the place of ``jdtype``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 6
    n_shared: int = 2          # shared (always-on) experts
    d_expert: int = 1408       # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 1024
    head_dim: Optional[int] = None   # default d_model // n_heads
    rope_theta: float = 1e4
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA width (h2o-danube)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid (zamba2): one shared attention block applied every N layers
    shared_attn_every: int = 0
    # vlm (llama-3.2-vision): cross-attention layer every N layers
    cross_attn_every: int = 0
    n_image_tokens: int = 1601       # stub frontend output length
    # encdec (whisper)
    encoder_layers: int = 0
    n_audio_frames: int = 1500       # stub conv frontend output length
    # deepseek-v3 multi-token prediction: extra MTP block predicting t+2
    mtp: bool = False

    max_seq: int = 8192

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        """Analytic parameter count (for 6*N*D model-FLOPs accounting)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        per_layer = 0
        if self.family == "ssm" or (self.family == "hybrid" and self.ssm):
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            conv_ch = d_in + 2 * s.n_groups * s.d_state
            per_layer = (
                d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
                + conv_ch * s.d_conv
                + nh  # A_log
                + nh  # D
                + d_in * d  # out_proj
                + d  # norm
            )
        if self.family in ("dense", "vlm", "encdec") or (
            self.family == "moe" and self.mla is None
        ):
            hd = self.hd
            attn = d * (self.n_heads * hd + 2 * self.n_kv_heads * hd) + self.n_heads * hd * d
            per_layer = attn + 2 * d
        if self.mla is not None:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
                + m.q_lora_rank + m.kv_lora_rank
            )
            per_layer = attn + 2 * d
        if self.family in ("dense", "vlm", "encdec"):
            per_layer += 3 * d * self.d_ff  # SwiGLU
        if self.family == "moe":
            mo = self.moe
            per_layer += d * mo.n_experts  # router
            per_layer += (mo.n_experts + mo.n_shared) * 3 * d * mo.d_expert
        total += L * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            hd = self.hd
            shared = (
                d * (self.n_heads * hd + 2 * self.n_kv_heads * hd)
                + self.n_heads * hd * d
                + 3 * d * self.d_ff
                + 2 * d
            )
            total += shared  # one shared block
        if self.family == "vlm" and self.cross_attn_every:
            pass  # cross-attn layers replace self-attn layers; same count
        if self.family == "encdec":
            total += self.encoder_layers * per_layer
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        mo = self.moe
        full = self.param_count()
        all_experts = self.n_layers * (mo.n_experts + mo.n_shared) * 3 * self.d_model * mo.d_expert
        active_experts = self.n_layers * (mo.top_k + mo.n_shared) * 3 * self.d_model * mo.d_expert
        return int(full - all_experts + active_experts)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
