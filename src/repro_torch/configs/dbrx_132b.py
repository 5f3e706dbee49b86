"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, head_dim=128, rope_theta=5e5,
    n_experts=16, top_k=4, capacity_factor=1.25,
    source="hf:databricks/dbrx-base; unverified",
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=256, head_dim=16, n_experts=4, top_k=2, capacity_factor=4.0,
)
