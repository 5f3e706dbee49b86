"""llama-3.2-vision-90b [vlm] — cross-attention image layers (backbone only;
the vision encoder is a stub: callers pass precomputed patch embeddings,
`vis`) [hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, head_dim=128, rope_theta=5e5,
    cross_attn_period=5, n_vis_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)

SMOKE = ModelConfig(
    name="llama32-vision-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, cross_attn_period=2, n_vis_tokens=8,
)
