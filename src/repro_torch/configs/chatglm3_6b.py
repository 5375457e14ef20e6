"""chatglm3-6b [dense; arXiv:2406.12793; hf]: 2d (partial) RoPE, 2-group GQA.

28L, d_model=4096, 32H (kv=2), d_ff=13696, vocab=65024, qkv bias.
ChatGLM applies rotary embedding to half of each head's dims
(rope_style='partial').
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="lm",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    mlp_act="swiglu", norm="rmsnorm", qkv_bias=True,
    rope_style="partial",
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="chatglm3-6b-smoke", family="lm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    mlp_act="swiglu", norm="rmsnorm", qkv_bias=True,
    rope_style="partial",
    max_seq_len=256,
)
