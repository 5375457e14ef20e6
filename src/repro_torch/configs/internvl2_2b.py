"""internvl2-2b [vlm; arXiv:2404.16821; hf]: InternViT (stub) + InternLM2.

LM backbone: 24L, d_model=2048, 16H (kv=8), d_ff=8192, vocab=92553. The
vision frontend is a stub, as in the reference: a batch carries 256
precomputed patch embeddings, prepended to the token embeddings; the loss
is taken on the text positions. Serving is text-only on the backbone.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    num_patches=256,
    mlp_act="swiglu", norm="rmsnorm", rope_theta=1e6,
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-2b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512,
    num_patches=8,
    mlp_act="swiglu", norm="rmsnorm",
    max_seq_len=256,
)
