"""mamba2-130m [ssm; arXiv:2405.21060]: SSD (state-space duality), attention
free.

24L, d_model=768, ssm_state=128, head_dim=64, expand=2 (24 heads of 64),
vocab=50280, tied head. No attention and no MLP: every block is the
Mamba2 mixer behind an RMSNorm. Its decode state is the same size at any
prompt length, so the 524,288-token ``long_500k`` shape runs
(``sub_quadratic``).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="lm",
    num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=0, vocab_size=50280,
    block_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=128),
    norm="rmsnorm", rope_style="none", tie_embeddings=True,
    sub_quadratic=True,
    max_seq_len=524288,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-130m-smoke", family="lm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=512,
    block_pattern=("ssm",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=1,
                  chunk=16),
    norm="rmsnorm", rope_style="none", tie_embeddings=True,
    sub_quadratic=True,
    max_seq_len=256,
)
