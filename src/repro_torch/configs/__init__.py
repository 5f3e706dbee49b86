"""Architecture registry: --arch <id> resolves here.

The port serves the dense, moe and ssm families: the plain dense
`qwen3-0.6b`, `phi4-mini-3.8b` and `smollm-360m`, `gemma3-12b` (5 local : 1
global sliding-window superblocks), the MoE `dbrx-132b` and
`llama4-scout-17b-a16e`, and `rwkv6-1.6b`.  The reference's hybrid, encdec
and vlm architectures are queued in ROADMAP.md and raise
NotImplementedError here.
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
    "dbrx-132b": "dbrx_132b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}
_QUEUED = ("llama-3.2-vision-90b", "hymba-1.5b", "seamless-m4t-medium")


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _QUEUED:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP.md, LM tier): the port "
            f"serves {', '.join(_ARCH_MODULES)}")
    mod = import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
