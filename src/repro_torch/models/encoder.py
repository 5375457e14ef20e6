"""Encoder-only MLM (the BERT family, the paper's second §4 validation
model): bidirectional self-attention blocks (the enc-dec encoder's blocks),
learned positions, the embedding tied to the MLM head; the masked-LM loss
(cross entropy on the positions of ``loss_mask``), each block recomputed in
the backward as the reference's ``jax.checkpoint`` does. No decode step: an
encoder has no cache (the reference's encoder-only archs skip the decode
shapes)."""
from __future__ import annotations

import functools

import torch

from repro_torch.device import dtype_of
from .attention import attn_defs
from .common import (ParamDef, apply_norm, cast_params, cross_entropy_loss,
                     mlp_defs, norm_defs)
from .encdec import encoder_block
from .lm import _remat, unstack_layers


def encoder_param_defs(cfg) -> dict:
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    n = cfg.num_layers
    defs = {"embed": ParamDef((v, d), ("vocab", "embed"), dtype=dt),
            "pos": ParamDef((cfg.max_seq_len, d), (None, "embed"),
                            scale=0.02, dtype=dt)}
    defs.update(attn_defs(cfg, "enc/attn", stack=n))
    defs.update(mlp_defs(cfg, "enc/mlp", stack=n))
    defs.update(norm_defs(cfg, "enc/ln1", stack=n))
    defs.update(norm_defs(cfg, "enc/ln2", stack=n))
    defs.update(norm_defs(cfg, "final_norm"))
    return defs


def encoder_forward(cfg, params, batch, *, mode: str = "reference",
                    qkv_plan: str = "rope_fused", remat: bool = False):
    """batch['inputs'] (or the token array itself): (B, S) token ids, [MASK]
    ids included -> logits (B, S, V) fp32; with ``remat`` each block is
    recomputed in the backward (``cfg.remat_policy``). (The reference also
    returns an auxiliary loss of 0.)"""
    cd = dtype_of(cfg.compute_dtype)
    params = cast_params(params, cd)
    tokens = batch["inputs"] if isinstance(batch, dict) else batch
    s = tokens.shape[1]
    x = params["embed"][tokens].to(cd) + params["pos"][:s].to(cd)
    block = functools.partial(encoder_block, cfg, mode=mode,
                              qkv_plan=qkv_plan)
    if remat:
        block = _remat(cfg, block)
    for p in unstack_layers(params["enc"], cfg.num_layers):
        x = block(p, x)
    x = apply_norm(cfg, x, params, "final_norm")
    return x.float() @ params["embed"].T.float()


def encoder_loss(cfg, params, batch, *, mode: str = "reference",
                 remat: bool = True, qkv_plan: str = "rope_fused"):
    """(loss, {"ce", "aux"}): the masked-LM cross entropy of the batch
    {"inputs", "targets", "loss_mask"} over the positions where loss_mask
    is 1; aux is 0 (the reference's aux_weight is 0 here)."""
    logits = encoder_forward(cfg, params, batch, mode=mode,
                             qkv_plan=qkv_plan, remat=remat)
    ce = cross_entropy_loss(logits, batch["targets"], batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=logits.device)}
