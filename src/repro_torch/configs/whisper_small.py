"""whisper-small [audio encdec]: 12L enc + 12L dec, d_model=768 12H
d_ff=3072 vocab=51865; conv frontend is a STUB (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    encoder_layers=12,
    n_audio_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    encoder_layers=2,
    n_audio_frames=30,
)
