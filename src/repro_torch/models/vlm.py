"""The vision-language model (InternVL2): the LM backbone behind a stub
vision frontend, as in the reference. A batch carries precomputed patch
embeddings (B, P, d_model), prepended to the token embeddings; the
backbone's blocks run causally over the P + S_text positions, and the
logits and the loss are taken on the text positions only. Serving is
text-only on the backbone (``models/api.py``), as the reference's. On a
tensor-parallel rank (``tp``) the backbone splits as the LM's does: the
vocab-parallel embedding of the text, the replicated patch embeddings
before it, the split blocks, head and cross entropy.
"""
from __future__ import annotations

import torch

from repro_torch.device import dtype_of
from .common import cast_params, cross_entropy_loss
from .lm import (_embed, _layout, _logits, _vocab_split, lm_blocks,
                 lm_param_defs)


def vlm_param_defs(cfg) -> dict:
    """The backbone's parameters (the frontend and its projector are the
    stub's)."""
    return lm_param_defs(cfg)


def _combined_embeds(cfg, params, batch, tp=None):
    """[patch embeddings in the compute type, the text tokens' embeddings
    times ``emb_scale``] along the sequence."""
    patches = batch["patch_embeds"].to(dtype_of(cfg.compute_dtype))
    return torch.cat([patches, _embed(cfg, params, batch["inputs"], tp)],
                     dim=1)


def _hidden(cfg, params, batch, *, mode, remat, qkv_plan, tp=None):
    if _layout(cfg)[0] != "scan":
        raise ValueError(f"{cfg.name}: the vlm backbone is a uniform stack; "
                         f"{cfg.num_layers} layers of "
                         f"{tuple(cfg.block_pattern)} are not")
    params = cast_params(params, dtype_of(cfg.compute_dtype))
    x, aux = lm_blocks(cfg, params, _combined_embeds(cfg, params, batch, tp),
                       mode=mode, remat=remat, qkv_plan=qkv_plan, tp=tp)
    return x[:, cfg.num_patches:], params, aux


def vlm_forward(cfg, params, batch, *, mode: str = "reference",
                remat: bool = False, qkv_plan: str = "rope_fused"):
    """batch {"patch_embeds" (B, P, d), "inputs" (B, S_text)} -> the text
    positions' logits (B, S_text, V) fp32. (The reference also returns the
    blocks' auxiliary loss, 0 for its dense backbone.)"""
    x, cast, _ = _hidden(cfg, params, batch, mode=mode, remat=remat,
                         qkv_plan=qkv_plan)
    return _logits(cfg, cast, x)


def vlm_loss(cfg, params, batch, *, mode: str = "reference",
             remat: bool = True, qkv_plan: str = "rope_fused", tp=None):
    """(loss, {"ce", "aux"}): the masked mean cross entropy of the text
    positions against ``batch["targets"]`` (B, S_text); the auxiliary loss
    is reported and not added, as in the reference. ``tp``: ``params`` are
    a tensor-parallel rank's blocks; the loss is replicated over 'model'."""
    x, cast, aux = _hidden(cfg, params, batch, mode=mode, remat=remat,
                           qkv_plan=qkv_plan, tp=tp)
    ce = cross_entropy_loss(_logits(cfg, cast, x, tp=tp), batch["targets"],
                            batch.get("loss_mask"),
                            tp=tp if _vocab_split(cfg, tp) else None)
    return ce, {"ce": ce, "aux": aux}
