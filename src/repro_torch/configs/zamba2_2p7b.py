"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 ssm_state=64 plus a
SHARED attention block (32H, d_ff=10240) applied every 6 layers.
[arXiv:2411.15242; hf]"""

from repro_torch.models.common import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    shared_attn_every=2,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16),
)
