"""The vision-language model (InternVL2): the LM backbone behind a stub
vision frontend, as in the reference. A batch carries precomputed patch
embeddings (B, P, d_model), prepended to the token embeddings; the
backbone's blocks run causally over the P + S_text positions, and the
logits and the loss are taken on the text positions only. Serving is
text-only on the backbone (``models/api.py``), as the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.device import dtype_of
from .common import cast_params, cross_entropy_loss
from .lm import _embed, _layout, _logits, lm_blocks, lm_param_defs


def vlm_param_defs(cfg) -> dict:
    """The backbone's parameters (the frontend and its projector are the
    stub's)."""
    return lm_param_defs(cfg)


def _combined_embeds(cfg, params, batch):
    """[patch embeddings in the compute type, the text tokens' embeddings
    times ``emb_scale``] along the sequence."""
    patches = batch["patch_embeds"].to(dtype_of(cfg.compute_dtype))
    return torch.cat([patches, _embed(cfg, params, batch["inputs"])], dim=1)


def _hidden(cfg, params, batch, *, mode, remat, qkv_plan):
    if _layout(cfg)[0] != "scan":
        raise ValueError(f"{cfg.name}: the vlm backbone is a uniform stack; "
                         f"{cfg.num_layers} layers of "
                         f"{tuple(cfg.block_pattern)} are not")
    params = cast_params(params, dtype_of(cfg.compute_dtype))
    x, aux = lm_blocks(cfg, params, _combined_embeds(cfg, params, batch),
                       mode=mode, remat=remat, qkv_plan=qkv_plan)
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
             remat: bool = True, qkv_plan: str = "rope_fused"):
    """(loss, {"ce", "aux"}): the masked mean cross entropy of the text
    positions against ``batch["targets"]`` (B, S_text); the auxiliary loss
    is reported and not added, as in the reference."""
    x, cast, aux = _hidden(cfg, params, batch, mode=mode, remat=remat,
                           qkv_plan=qkv_plan)
    ce = cross_entropy_loss(_logits(cfg, cast, x), batch["targets"],
                            batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": aux}
