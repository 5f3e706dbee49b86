"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay
[arXiv:2404.05892; unverified].  Heads are d_model/64 (RWKV convention)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab=65536, head_dim=64,
    source="arXiv:2404.05892; unverified",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=32,
)
