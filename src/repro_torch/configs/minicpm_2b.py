"""minicpm-2b [dense; arXiv:2404.06395; hf]: llama-like, WSD schedule.

40L, d_model=2304, 36H (kv=36 — MHA), d_ff=5760, vocab=122753.
MiniCPM quirks: scale_emb=12, residual scale_depth=1.4/sqrt(L), logits
divided by d_model/dim_model_base = 2304/256 = 9, tied embeddings.
Training uses the WSD (warmup-stable-decay) schedule: repro_torch.optim.
"""
import math
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="lm",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True,
    emb_scale=12.0, residual_scale=1.4 / math.sqrt(40),
    logit_scale_div=2304 / 256,
    max_seq_len=32768,
)

SMOKE_CONFIG = ModelConfig(
    name="minicpm-2b-smoke", family="lm",
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=512,
    mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True,
    emb_scale=12.0, residual_scale=1.4 / math.sqrt(3),
    logit_scale_div=96 / 32,
    max_seq_len=256,
)
