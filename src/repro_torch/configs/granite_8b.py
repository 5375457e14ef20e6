"""granite-8b [dense; arXiv:2405.04324; hf]: llama-arch code model.

36L, d_model=4096, 32H (kv=8), d_ff=14336, vocab=49152.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="lm",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=49152,
    mlp_act="swiglu", norm="rmsnorm", rope_theta=10000.0,
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-8b-smoke", family="lm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    mlp_act="swiglu", norm="rmsnorm",
    max_seq_len=256,
)
