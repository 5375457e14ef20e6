"""whisper-base [audio; arXiv:2212.04356]: enc-dec, conv frontend stubbed.

6L enc + 6L dec, d_model=512, 8H (kv=8), d_ff=2048, vocab=51865.
NOTE: real Whisper caps decoder positions at 448; the reference's shape
set exercises the backbone at 4k/32k decoder lengths, so the learned
position table is sized to max_seq_len (the reference's recorded
deviation).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, encoder_layers=6, d_model=512,
    num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865,
    mlp_act="gelu", norm="layernorm", rope_style="none",
    tie_embeddings=True, encoder_seq=1500, max_target_positions=448,
    max_seq_len=32768 + 8,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-base-smoke", family="encdec",
    num_layers=2, encoder_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    mlp_act="gelu", norm="layernorm", rope_style="none",
    tie_embeddings=True, encoder_seq=32, max_target_positions=64,
    max_seq_len=128,
)
