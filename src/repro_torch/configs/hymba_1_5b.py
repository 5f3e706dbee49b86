"""hymba-1.5b [hybrid] — parallel attention + mamba heads in every layer;
sliding-window attention except 3 global layers [arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64, rope_theta=1e4,
    ssm_state=16, sliding_window=2048, global_layers=(0, 15, 31),
    source="arXiv:2411.13676; hf",
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, ssm_state=4, sliding_window=16,
    global_layers=(1,),
)
