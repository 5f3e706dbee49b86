"""Model and shape configurations of the LM tier.

The port's own copy of the reference's `repro.configs.base` (which imports
JAX): every architecture is a `ModelConfig`, every workload shape a
`ShapeConfig`.  `input_specs` gives allocation-free stand-ins for every
model input of a cell, the reference's `ShapeDtypeStruct`s as tensors on
the `meta` device (shapes and types, no storage), for the dry run
(`launch.dryrun`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "cell_enabled",
           "input_specs", "param_count", "active_param_count"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    # sliding-window pattern: swa_period=6 => 5 local + 1 global (gemma3)
    sliding_window: int = 0     # 0 = none
    swa_period: int = 0
    global_layers: tuple = ()   # explicit global-attention layers (hymba)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    # encoder-decoder
    n_enc_layers: int = 0
    # VLM cross-attention
    cross_attn_period: int = 0  # every Nth layer cross-attends
    n_vis_tokens: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / mostly-sliding-window."""
        return self.family in ("ssm", "hybrid") or self.swa_period > 0


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_enabled(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a valid cell; reason when skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 512k decode skipped (DESIGN.md)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every model input of the cell (no
    allocation): the reference's names, shapes and types."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": spec((B, S), i32)}
        if shape.kind == "train":
            batch["labels"] = spec((B, S), i32)
        if cfg.is_encdec:   # audio frontend stub: precomputed frame embeddings
            batch["frames"] = spec((B, S, cfg.d_model), bf16)
        if cfg.family == "vlm":  # vision frontend stub: patch embeddings
            batch["vis"] = spec((B, cfg.n_vis_tokens, cfg.d_model), bf16)
        return batch
    if shape.kind == "decode":
        return {"tokens": spec((B, 1), i32), "pos": spec((), i32)}
    raise ValueError(shape.kind)


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (approximate, matches the built model)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    qkv = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if cfg.family == "ssm":     # rwkv6: time-mix + channel-mix
        per_layer = 4 * d * d + d * f + f * d + 2 * d  # r,k,v,g,o approx + cmix
    else:
        mlp = 3 * d * f         # swiglu
        if cfg.n_experts:
            mlp = cfg.n_experts * 3 * d * f + d * cfg.n_experts
        per_layer = qkv + mlp
        if cfg.family == "hybrid":
            per_layer += 2 * d * cfg.ssm_state + d * d  # ssm head extras
    n_layers = cfg.n_layers + cfg.n_enc_layers
    cross = 0
    if cfg.cross_attn_period:
        cross = (cfg.n_layers // cfg.cross_attn_period) * qkv
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return n_layers * per_layer + cross + emb


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top_k experts count)."""
    if not cfg.n_experts:
        return param_count(cfg)
    d, f = cfg.d_model, cfg.d_ff
    dense_moe_delta = (cfg.n_experts - cfg.top_k) * 3 * d * f * cfg.n_layers
    return param_count(cfg) - dense_moe_delta
