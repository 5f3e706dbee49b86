"""Architecture registry: --arch <id> resolves here.

The reference's ten architectures: the plain dense `qwen3-0.6b`,
`phi4-mini-3.8b` and `smollm-360m`, `gemma3-12b` (5 local : 1 global
sliding-window superblocks), the vlm `llama-3.2-vision-90b` (4 self : 1
cross-attention superblocks over patch embeddings), the hybrid `hymba-1.5b`
(attention and SSM heads in parallel), the encoder-decoder
`seamless-m4t-medium`, the MoE `dbrx-132b` and `llama4-scout-17b-a16e`,
and `rwkv6-1.6b`.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      active_param_count, cell_enabled,
                                      param_count)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "param_count",
           "active_param_count", "cell_enabled", "get_config", "list_archs"]

_ARCH_MODULES = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "smollm-360m": "smollm_360m",
    "qwen3-0.6b": "qwen3_0_6b",
    "gemma3-12b": "gemma3_12b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "hymba-1.5b": "hymba_1_5b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "dbrx-132b": "dbrx_132b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
