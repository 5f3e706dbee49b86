"""gemma3-12b [dense] — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=256, rope_theta=1e6,
    sliding_window=1024, swa_period=6,      # 5 local : 1 global
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, sliding_window=16, swa_period=6,
    tie_embeddings=True,
)
