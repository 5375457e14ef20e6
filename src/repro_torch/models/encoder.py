"""Encoder-only MLM (the BERT family, the paper's second §4 validation
model): bidirectional self-attention blocks (the enc-dec encoder's blocks),
learned positions, the embedding tied to the MLM head. No decode step: an
encoder has no cache (the reference's encoder-only archs skip the decode
shapes)."""
from __future__ import annotations

from repro_torch.device import dtype_of
from .attention import attn_defs
from .common import (ParamDef, apply_norm, cast_params, mlp_defs, norm_defs)
from .encdec import encoder_block
from .lm import unstack_layers


def encoder_param_defs(cfg) -> dict:
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    n = cfg.num_layers
    defs = {"embed": ParamDef((v, d), dtype=dt),
            "pos": ParamDef((cfg.max_seq_len, d), scale=0.02, dtype=dt)}
    defs.update(attn_defs(cfg, "enc/attn", stack=n))
    defs.update(mlp_defs(cfg, "enc/mlp", stack=n))
    defs.update(norm_defs(cfg, "enc/ln1", stack=n))
    defs.update(norm_defs(cfg, "enc/ln2", stack=n))
    defs.update(norm_defs(cfg, "final_norm"))
    return defs


def encoder_forward(cfg, params, batch, *, mode: str = "reference",
                    qkv_plan: str = "rope_fused"):
    """batch['inputs'] (or the token array itself): (B, S) token ids, [MASK]
    ids included -> logits (B, S, V) fp32. (The reference also returns an
    auxiliary loss of 0.)"""
    cd = dtype_of(cfg.compute_dtype)
    params = cast_params(params, cd)
    tokens = batch["inputs"] if isinstance(batch, dict) else batch
    s = tokens.shape[1]
    x = params["embed"][tokens].to(cd) + params["pos"][:s].to(cd)
    for p in unstack_layers(params["enc"], cfg.num_layers):
        x = encoder_block(cfg, p, x, mode=mode, qkv_plan=qkv_plan)
    x = apply_norm(cfg, x, params, "final_norm")
    return x.float() @ params["embed"].T.float()
