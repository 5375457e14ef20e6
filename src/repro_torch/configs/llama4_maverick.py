"""llama4-maverick-400b-a17b [moe; hf:meta-llama; unverified].

48L, d_model=5120, 40H (kv=8), d_ff=8192 per expert, vocab=202048,
MoE 128 experts top-1, interleaved dense/MoE layers (Maverick's
interleave_moe_layer_step=2: layer 2i is attention with the dense SwiGLU
MLP, layer 2i + 1 attention with the MoE). The pattern divides the depth,
so the parameters stack by pattern position (``blocks_0``, ``blocks_1``).
The text backbone only; no shared expert, chunked attention, QK norm or
NoPE layers, as the reference's config.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="lm",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    block_pattern=("attn", "moe"),
    moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25),
    mlp_act="swiglu", norm="rmsnorm", rope_theta=500000.0,
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="llama4-maverick-smoke", family="lm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    block_pattern=("attn", "moe"),
    moe=MoEConfig(num_experts=8, top_k=1, capacity_factor=2.0),
    mlp_act="swiglu", norm="rmsnorm",
    max_seq_len=256,
)
