"""The paper's §4 validation models at their published widths: the Llama
pretraining-parity models and BERT-base, the same values as the reference
package's configs."""
from .base import ModelConfig

LLAMA_100M = ModelConfig(
    name="llama-100m", family="lm",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=2048, vocab_size=32000,
    mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True,
    max_seq_len=2048,
)

LLAMA_1B = ModelConfig(
    name="llama-1b", family="lm",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True,
    max_seq_len=8192,
)

# The paper's second §4 validation model: BERT-base (110M), encoder-only MLM.
BERT_110M = ModelConfig(
    name="bert-110m", family="encoder",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=30522,
    mlp_act="gelu", norm="layernorm", rope_style="none",
    tie_embeddings=True, max_seq_len=512,
)
