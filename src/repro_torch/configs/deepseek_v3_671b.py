"""deepseek-v3-671b [moe]: 61L d_model=7168 128H (MLA) expert_d_ff=2048
vocab=129280; 1 shared + 256 routed experts top-8; multi-head latent
attention; multi-token prediction.  [arXiv:2412.19437; hf]"""

from repro_torch.models.common import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab=129280,
    moe=MoEConfig(
        n_experts=256, top_k=8, n_shared=1, d_expert=2048, capacity_factor=1.25
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    mtp=True,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="deepseek-v3-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=64),
    mla=MLAConfig(
        q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
    ),
    mtp=True,
)
