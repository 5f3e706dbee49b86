"""Architecture registry: --arch <id> resolves here.

The port serves the dense and ssm families: `qwen3-0.6b` and `rwkv6-1.6b`.
The reference's other architectures (moe, hybrid, encdec, vlm, sliding
window) are queued in ROADMAP.md and raise NotImplementedError here.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      param_count)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "param_count",
           "get_config", "list_archs"]

_ARCH_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}
_QUEUED = ("phi4-mini-3.8b", "smollm-360m", "gemma3-12b",
           "llama-3.2-vision-90b", "hymba-1.5b", "seamless-m4t-medium",
           "dbrx-132b", "llama4-scout-17b-a16e")


def list_archs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _QUEUED:
        raise NotImplementedError(
            f"{arch} is not ported yet (ROADMAP.md, LM tier): the port "
            f"serves {', '.join(_ARCH_MODULES)}")
    mod = import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
