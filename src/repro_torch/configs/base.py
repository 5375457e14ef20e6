"""Model configuration: one frozen dataclass per architecture.

The port's own copy of the reference ``ModelConfig``, ``MoEConfig``,
``SSMConfig`` and ``RGLRUConfig``, cut to the fields the port's families
read: the decoder-only LM (dense, with mixture-of-experts blocks, Mamba2's
SSD blocks, or the hybrid of RG-LRU recurrent and local-attention blocks),
the vision-language model (an LM backbone behind stub patch embeddings),
the encoder and the encoder-decoder.
Field names and defaults are the reference's, so ``dataclasses.replace``
sizes a config the same way on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    impl: str = "auto"  # 'dense' | 'ep' | 'tp' | 'auto'; one device: dense
    # weight sharding of the distributed paths: 'expert' or 'ffn'
    shard: str = "expert"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: Optional[int] = None   # defaults to d_model
    conv_width: int = 4
    c_exponent: float = 8.0
    local_window: int = 2048


# the families served on the decoder-only surface: the LM, and the VLM on
# its text backbone (as the reference's)
DECODER_FAMILIES = ("lm", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # 'lm' | 'encdec' | 'encoder' | 'vlm'
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    # block pattern, cycled over layers: 'attn' (attention + MLP), 'moe'
    # (attention + mixture-of-experts FFN), 'ssm' (Mamba2 block, no MLP),
    # 'rg' (RG-LRU block + MLP), 'local' (attention in rglru.local_window +
    # MLP)
    block_pattern: Sequence[str] = ("attn",)
    mlp_act: str = "swiglu"     # 'swiglu' | 'geglu' | 'gelu'
    norm: str = "rmsnorm"       # 'rmsnorm' | 'layernorm'
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_style: str = "half"    # 'half' | 'partial' | 'none'
    attn_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # enc-dec (whisper): encoder stack dims (decoder uses the main fields)
    encoder_layers: int = 0
    encoder_seq: int = 1500      # precomputed frame embeddings (frontend stub)
    max_target_positions: int = 448
    # vlm: number of prepended patch embeddings (frontend stub)
    num_patches: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    ce_chunk: int = 0            # >0: chunked CE loss over this many positions
    remat_policy: str = "full"   # 'full' | 'dots' (save matmul outputs) | 'none'
    rglru_f32_gates: bool = True # False: bf16 gate products (fp32 carries)
    rglru_chunk: int = 0         # >0: two-level RG-LRU scan (models/rglru.py)
    # the distributed layer's sharding levers (distributed/sharding.py)
    embed_shard: str = "vocab"   # 'vocab' | 'embed': which dim of the
                                 # embedding goes over 'model' (untied only)
    kv_shard: bool = True        # False: replicate wv (kv heads < |model|)
    fsdp: bool = False           # shard the params over 'data' too
    vocab_pad_multiple: int = 0  # pad V up to a multiple; padding is masked
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale_div: float = 1.0
    max_seq_len: int = 8192
    sub_quadratic: bool = False  # True => long_500k shape is runnable

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(1, self.num_kv_heads):
            raise ValueError(f"num_heads {self.num_heads} is not a multiple "
                             f"of num_kv_heads {self.num_kv_heads}")

    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        if not m:
            return self.vocab_size
        return -(-self.vocab_size // m) * m

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]
