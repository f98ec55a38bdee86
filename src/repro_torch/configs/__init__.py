"""Architecture registry: one module per assigned architecture.

Each config module defines FULL (the assigned published configuration)
and SMOKE (a reduced same-family configuration for CPU tests).
"""

from importlib import import_module

ARCHS = [
    "zamba2_2p7b",
    "qwen2_0p5b",
    "h2o_danube_1p8b",
    "stablelm_12b",
    "granite_3_2b",
    "llama32_vision_11b",
    "deepseek_v3_671b",
    "deepseek_moe_16b",
    "mamba2_780m",
    "whisper_small",
]

# canonical ids as assigned (hyphenated)
ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-0.5b": "qwen2_0p5b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "stablelm-12b": "stablelm_12b",
    "granite-3-2b": "granite_3_2b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-780m": "mamba2_780m",
    "whisper-small": "whisper_small",
}


def get_config(name: str, smoke: bool = False):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    mod = import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.FULL


def all_arch_names():
    return list(ALIASES.keys())
