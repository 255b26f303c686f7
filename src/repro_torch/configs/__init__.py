"""Architecture registry of the PyTorch port.

Each module exposes ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family configuration for CPU tests),
under the reference's names and aliases: the paper CNN and the ten LM
architectures (dense, MoE, SSM, hybrid, audio and VLM families).
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_moe_16b, gemma3_12b, jamba_v0_1_52b, llama3_405b,
    llama_3_2_vision_90b, mamba2_370m, mixtral_8x7b, musicgen_large,
    nemotron_4_340b, paper_cnn, qwen3_1_7b)

_ARCHS = {m.__name__.rsplit(".", 1)[1]: m for m in (
    mixtral_8x7b, deepseek_moe_16b, llama3_405b, qwen3_1_7b, gemma3_12b,
    nemotron_4_340b, mamba2_370m, musicgen_large, jamba_v0_1_52b,
    llama_3_2_vision_90b, paper_cnn)}
ARCHS = tuple(_ARCHS)
LM_ARCHS = tuple(a for a in ARCHS if a != "paper_cnn")

_ALIASES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama3-405b": "llama3_405b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma3-12b": "gemma3_12b",
    "nemotron-4-340b": "nemotron_4_340b",
    "mamba2-370m": "mamba2_370m",
    "musicgen-large": "musicgen_large",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}


def get(name: str, smoke: bool = False):
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    try:
        mod = _ARCHS[mod_name]
    except KeyError:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(_ARCHS)}") from None
    return mod.smoke_config() if smoke else mod.config()
