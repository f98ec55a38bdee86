"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) expert_d_ff=1408
vocab=102400; 2 shared + 64 routed experts, top-6, fine-grained.
[arXiv:2401.06066; hf]"""

from repro_torch.models.common import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    moe=MoEConfig(
        n_experts=64, top_k=6, n_shared=2, d_expert=1408, capacity_factor=1.25
    ),
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=256,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=96),
)
