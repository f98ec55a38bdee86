"""Models of the port: the dense, ssm, hybrid, vlm, encdec and moe
families' serving path and training loss (:mod:`.transformer`), built
from :mod:`.layers`, GQA, cross-attention and multi-head latent
attention (:mod:`.attention`), the Mamba2 block
(:mod:`.ssm`) and the mixture-of-experts block (:mod:`.moe`), with the
configuration dataclasses (:mod:`.common`) and the bridge that carries
the JAX reference's weights across (:mod:`.convert`)."""

from .common import SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeConfig, SSMConfig
from .moe import MoE, moe_apply
from .transformer import (
    Model,
    decode_step,
    encode_memory,
    forward,
    forward_hidden,
    init_cache,
    init_params,
    layer_pattern,
    prefill,
)

__all__ = ["MLAConfig", "Model", "ModelConfig", "MoE", "MoEConfig", "SHAPES",
           "SSMConfig", "ShapeConfig", "decode_step", "encode_memory", "forward",
           "forward_hidden", "init_cache", "init_params", "layer_pattern",
           "moe_apply", "prefill"]
