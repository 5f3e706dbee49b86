"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B; hf",
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=32, qk_norm=True, tie_embeddings=True,
)
