"""qwen2-72b [dense; arXiv:2407.10671; hf]: GQA with QKV bias.

80L, d_model=8192, 64H (kv=8), d_ff=29568, vocab=152064, rope theta 1e6.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="lm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    mlp_act="swiglu", norm="rmsnorm", qkv_bias=True, rope_theta=1e6,
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-72b-smoke", family="lm",
    num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    mlp_act="swiglu", norm="rmsnorm", qkv_bias=True, rope_theta=1e6,
    max_seq_len=256,
)
