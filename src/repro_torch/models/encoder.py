"""Encoder-only MLM (the BERT family, the paper's second §4 validation
model): bidirectional self-attention blocks (the enc-dec encoder's blocks),
learned positions, the embedding tied to the MLM head; the masked-LM loss
(cross entropy on the positions of ``loss_mask``), each block recomputed in
the backward as the reference's ``jax.checkpoint`` does. No decode step: an
encoder has no cache (the reference's encoder-only archs skip the decode
shapes). On a tensor-parallel rank (``tp``) the blocks split as the
enc-dec encoder's, ``pos`` is replicated, and the tied table's vocab rows
give the vocab-parallel lookup, head and cross entropy where the extent
divides the vocab (else the whole table on every rank)."""
from __future__ import annotations

import functools

import torch

from repro_torch.device import dtype_of
from .attention import attn_defs
from .common import (ParamDef, cast_params, cross_entropy_loss,
                     mlp_defs, norm_defs)
from .encdec import _logits, encoder_block
from .lm import _remat, _vocab_split, lookup, unstack_layers


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
                    qkv_plan: str = "rope_fused", remat: bool = False,
                    tp=None):
    """batch['inputs'] (or the token array itself): (B, S) token ids, [MASK]
    ids included -> logits (B, S, V) fp32; with ``remat`` each block is
    recomputed in the backward (``cfg.remat_policy``). (The reference also
    returns an auxiliary loss of 0.) ``tp``: ``params`` are a
    tensor-parallel rank's blocks, the logits its vocab columns where the
    table's rows are split."""
    cd = dtype_of(cfg.compute_dtype)
    params = cast_params(params, cd)
    tokens = batch["inputs"] if isinstance(batch, dict) else batch
    s = tokens.shape[1]
    x = lookup(params["embed"], tokens, tp).to(cd) + params["pos"][:s].to(cd)
    block = functools.partial(encoder_block, cfg, mode=mode,
                              qkv_plan=qkv_plan, tp=tp)
    if remat:
        block = _remat(cfg, block)
    for p in unstack_layers(params["enc"], cfg.num_layers):
        x = block(p, x)
    return _logits(cfg, params, x, tp)


def encoder_loss(cfg, params, batch, *, mode: str = "reference",
                 remat: bool = True, qkv_plan: str = "rope_fused", tp=None):
    """(loss, {"ce", "aux"}): the masked-LM cross entropy of the batch
    {"inputs", "targets", "loss_mask"} over the positions where loss_mask
    is 1; aux is 0 (the reference's aux_weight is 0 here). ``tp``:
    replicated over 'model'."""
    logits = encoder_forward(cfg, params, batch, mode=mode,
                             qkv_plan=qkv_plan, remat=remat, tp=tp)
    ce = cross_entropy_loss(logits, batch["targets"], batch.get("loss_mask"),
                            tp=tp if _vocab_split(cfg, tp) else None)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=logits.device)}
