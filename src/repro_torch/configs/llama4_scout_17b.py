"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Per the assigned config
all layers are MoE with top-1 routing (the HF release interleaves a shared
expert — deviation noted in DESIGN.md §9); early-fusion multimodality is a
frontend concern and out of backbone scope."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, rope_theta=5e5,
    n_experts=16, top_k=1, capacity_factor=1.5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=256, head_dim=16, n_experts=4, top_k=1, capacity_factor=4.0,
)
