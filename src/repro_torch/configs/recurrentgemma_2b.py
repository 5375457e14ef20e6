"""recurrentgemma-2b [hybrid; arXiv:2402.19427; hf]: RG-LRU + local attn 1:2.

26L, d_model=2560, 10H (kv=1: MQA), d_ff=7680 (GeGLU), vocab=256000.
Block pattern (rg, rg, local): two recurrent blocks per local-attention
block (window 2048), head_dim 256. 26 = 8 x 3 + 2 layers: the pattern does
not divide the depth, so the parameters are per layer (``layer_{i:03d}``);
the smoke config's 3 layers stack by pattern position (``blocks_{i}``).
"""
import math

from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="lm",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000,
    block_pattern=("rg", "rg", "local"),
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, c_exponent=8.0,
                      local_window=2048),
    mlp_act="geglu", norm="rmsnorm", tie_embeddings=True,
    emb_scale=math.sqrt(2560), sub_quadratic=True,
    max_seq_len=524288,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-2b-smoke", family="lm",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=512,
    block_pattern=("rg", "rg", "local"),
    rglru=RGLRUConfig(lru_width=64, conv_width=4, c_exponent=8.0,
                      local_window=32),
    mlp_act="geglu", norm="rmsnorm", tie_embeddings=True,
    emb_scale=8.0, sub_quadratic=True,
    max_seq_len=256,
)
