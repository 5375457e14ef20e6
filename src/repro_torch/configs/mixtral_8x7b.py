"""mixtral-8x7b [moe; arXiv:2401.04088; hf]: 8 experts top-2, SWA.

32L, d_model=4096, 32H (kv=8), d_ff=14336 per expert, vocab=32000.
Sliding-window attention (4096) keeps decode memory O(window): the
contiguous cache is a 4096-slot ring.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="lm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25, shard="ffn"),
    attn_window=4096, sub_quadratic=True,
    mlp_act="swiglu", norm="rmsnorm", rope_theta=1e6,
    max_seq_len=524288,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-8x7b-smoke", family="lm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0),
    attn_window=32, sub_quadratic=True,
    mlp_act="swiglu", norm="rmsnorm",
    max_seq_len=256,
)
