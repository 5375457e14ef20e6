"""Decoder-only LM: embedding, a stack of dense attention blocks, tied or
untied logits; full-sequence forward, prefill and one-token decode.

Layer parameters are stacked with a leading layer axis (the reference's
scan layout, same keys and shapes); a Python loop over layers takes the
place of ``lax.scan``. The parameters come in the compute type already:
the reference casts them on every call (``cast_params``), the port casts
them once when they are made (``Model.init``, ``params_from_numpy``) and
keeps that one copy; the numbers are the same. The port runs 'attn'
blocks only; any other block kind raises.
"""
from __future__ import annotations

import torch

from repro_torch.device import dtype_of
from .attention import (attend, attn_defs, decode_attention_layer,
                        init_attn_cache, prefill_attn_cache,
                        project_qkv_heads, _merge_heads, attention_layer)
from .common import (ParamDef, apply_norm, mlp_defs, mlp_forward,
                     norm_defs, norm_params, tree_map)


def check_supported(cfg) -> None:
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: the port runs 'attn' blocks only, got {sorted(kinds)}")
    if cfg.family != "lm":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r}; the "
                                  "port runs decoder-only LMs ('lm')")


def lm_param_defs(cfg) -> dict:
    check_supported(cfg)
    d, v, dt = cfg.d_model, cfg.padded_vocab(), cfg.param_dtype
    n = cfg.num_layers
    defs = {"embed": ParamDef((v, d), dtype=dt)}
    defs.update(attn_defs(cfg, "blocks/attn", stack=n))
    defs.update(norm_defs(cfg, "blocks/ln1", stack=n))
    defs.update(norm_defs(cfg, "blocks/ln2", stack=n))
    defs.update(mlp_defs(cfg, "blocks/mlp", stack=n))
    defs.update(norm_defs(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), dtype=dt)
    return defs


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked block params."""
    return tree_map(lambda x: x[i], params["blocks"])


def _embed(cfg, params, tokens):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype)) \
        * cfg.emb_scale


def _logits(cfg, params, x):
    x = apply_norm(cfg, x, params, "final_norm")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.float() @ head.float()
    if cfg.padded_vocab() != cfg.vocab_size:
        # the padding columns carry no probability mass
        pad = torch.arange(cfg.padded_vocab(), device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits / cfg.logit_scale_div


def block_forward(cfg, p, x, *, positions, mode: str = "reference"):
    """One dense block on the pre-norm residual stream ``x``: ln1 and ln2
    ride into the attention/MLP layers as ``prenorm``."""
    rs = cfg.residual_scale
    a = attention_layer(cfg, p["attn"], x, window=cfg.attn_window,
                        positions=positions, mode=mode,
                        prenorm=norm_params(p, "ln1"))
    x = x + rs * a
    return mlp_forward(cfg, p["mlp"], x, mode=mode, residual=x,
                       residual_scale=rs, prenorm=norm_params(p, "ln2"))


def lm_forward(cfg, params, tokens, *, mode: str = "reference"):
    """tokens: (B, S) -> logits (B, S, V) fp32. (The reference also returns
    the MoE auxiliary loss; dense blocks have none.)"""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        x = block_forward(cfg, layer_params(params, i), x,
                          positions=positions, mode=mode)
    return _logits(cfg, params, x)


def lm_init_cache(cfg, batch: int, max_len: int, device) -> dict:
    return init_attn_cache(cfg, batch, max_len, cfg.attn_window,
                           dtype_of(cfg.compute_dtype), device,
                           layers=cfg.num_layers)


def block_prefill(cfg, p, x, k_cache, v_cache, *, positions,
                  mode: str = "reference"):
    """Full-sequence block that also fills its layer's cache (in place)."""
    q, k, v = project_qkv_heads(cfg, p["attn"], x, positions, mode=mode,
                                prenorm=norm_params(p, "ln1"))
    o = attend(cfg, q, k, v, window=cfg.attn_window, mode=mode)
    prefill_attn_cache(k_cache, v_cache, k, v)
    x = x + cfg.residual_scale * (_merge_heads(o) @ p["attn"]["wo"])
    return mlp_forward(cfg, p["mlp"], x, mode=mode, residual=x,
                       residual_scale=cfg.residual_scale,
                       prenorm=norm_params(p, "ln2"))


def block_decode(cfg, p, x, k_cache, v_cache, pos: int, *,
                 mode: str = "reference"):
    rs = cfg.residual_scale
    h = apply_norm(cfg, x, p, "ln1")
    a = decode_attention_layer(cfg, p["attn"], h, k_cache, v_cache, pos,
                               window=cfg.attn_window, mode=mode)
    x = x + rs * a
    return mlp_forward(cfg, p["mlp"], x, mode=mode, residual=x,
                       residual_scale=rs, prenorm=norm_params(p, "ln2"))


def lm_prefill(cfg, params, tokens, cache, *, mode: str = "reference"):
    """Fills ``cache`` in place. Returns (cache, last-position logits
    (B, V))."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        x = block_prefill(cfg, layer_params(params, i), x, cache["k"][i],
                          cache["v"][i], positions=positions, mode=mode)
    return cache, _logits(cfg, params, x[:, -1:, :])[:, 0]


def lm_decode_step(cfg, params, token, cache, pos: int, *,
                   mode: str = "reference"):
    """token: (B, 1); pos: the position being written. Updates ``cache`` in
    place. Returns (cache, logits (B, V))."""
    x = _embed(cfg, params, token)
    for i in range(cfg.num_layers):
        x = block_decode(cfg, layer_params(params, i), x, cache["k"][i],
                         cache["v"][i], pos, mode=mode)
    return cache, _logits(cfg, params, x)[:, 0]
