"""seamless-m4t-medium [audio] — encoder-decoder, multimodal
[arXiv:2308.11596; hf].  Backbone only: 12 encoder + 12 decoder layers
(the reference reads "12L" at medium size as per stack); the speech
frontend is a stub: callers pass precomputed frame embeddings (`frames`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, rope_theta=1e4,
    source="arXiv:2308.11596; hf",
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
)
