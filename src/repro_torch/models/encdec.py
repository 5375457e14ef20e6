"""Encoder-decoder transformer (the Whisper backbone; the conv frontend is a
stub, as in the reference: the batch carries precomputed frame embeddings).

Encoder: bidirectional self-attention blocks over (B, S_enc, D) embeddings
with sinusoidal positions. Decoder: causal self-attention, cross-attention
and MLP, learned positions. LayerNorm and GELU, the embedding tied to the
head. Layer parameters are stacked (``enc/...``, ``dec/...``, the
reference's scan layout); a Python loop over layers takes the place of
``lax.scan``. Training (``encdec_loss``) recomputes each encoder and each
decoder block in the backward, as the reference checkpoints the bodies of
its two scans.

Serving: the encoder runs once, in the prefill, which writes each layer's
cross-attention k/v in place into the cache it is given (the ``cross``
part, a (L, B, Hkv, S_enc, hd) stack) beside the decoder's self-attention
ring (``self``); a decode step reads the cross part and never writes it.
As in ``lm``, the full-sequence forward casts the parameters to the
compute type, and the prefill and the decode step take them cast already
(``Model.init``, ``params_from_numpy``).

Training on a tensor-parallel rank (``tp``, ``distributed.tensor_parallel``)
splits both stacks by the reference's rules: each attention's heads (the
cross-attention's too: q from the decoder's stream, k and v from the
replicated encoder output, which enters each layer through f), the MLP's
FFN columns, and the tied embedding's vocab rows with the vocab-parallel
head and cross entropy where the extent divides the vocab.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.device import dtype_of
from .attention import (attend, attention_layer, attn_defs,
                        decode_attention_layer, init_attn_cache,
                        prefill_attn_cache, project_qkv, project_qkv_heads,
                        split_attention_layer, _merge_heads)
from .common import (ParamDef, apply_norm, cast_params, cross_entropy_loss,
                     mlp_defs, mlp_forward, norm_defs, norm_params,
                     split_mlp_forward)
from .lm import _remat, _vocab_split, lookup, unstack_layers


def sinusoidal_positions(length: int, dim: int, device=None):
    """(length, dim) fp32 table: sin of pos / 10000^(2 i / dim) in the first
    half, cos in the second."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / torch.pow(torch.tensor(10000.0, device=device),
                             2 * idx / dim)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def encdec_param_defs(cfg) -> dict:
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    defs = {"embed": ParamDef((v, d), ("vocab", "embed"), dtype=dt),
            "dec_pos": ParamDef((cfg.max_seq_len, d), (None, "embed"),
                                scale=0.02, dtype=dt)}
    enc = cfg.encoder_layers
    defs.update(attn_defs(cfg, "enc/attn", stack=enc))
    defs.update(mlp_defs(cfg, "enc/mlp", stack=enc))
    defs.update(norm_defs(cfg, "enc/ln1", stack=enc))
    defs.update(norm_defs(cfg, "enc/ln2", stack=enc))
    defs.update(norm_defs(cfg, "enc_final_norm"))
    dec = cfg.num_layers
    defs.update(attn_defs(cfg, "dec/attn", stack=dec))
    defs.update(attn_defs(cfg, "dec/xattn", stack=dec, cross=True))
    defs.update(mlp_defs(cfg, "dec/mlp", stack=dec))
    defs.update(norm_defs(cfg, "dec/ln1", stack=dec))
    defs.update(norm_defs(cfg, "dec/lnx", stack=dec))
    defs.update(norm_defs(cfg, "dec/ln2", stack=dec))
    defs.update(norm_defs(cfg, "final_norm"))
    return defs


def _attention(cfg, p, x, *, tp, **kw):
    """``attention_layer``, or on a tensor-parallel rank its split form."""
    if tp is None:
        return attention_layer(cfg, p, x, **kw)
    return split_attention_layer(cfg, p, x, tp=tp, **kw)


def _mlp(cfg, p, x, *, tp, **kw):
    """``mlp_forward``, or on a tensor-parallel rank its split form."""
    if tp is None:
        return mlp_forward(cfg, p, x, **kw)
    return split_mlp_forward(cfg, p, x, tp=tp, **kw)


def encoder_block(cfg, p, h, *, mode: str, qkv_plan: str = "rope_fused",
                  tp=None):
    """One bidirectional block on the pre-norm stream: ln1 and ln2 ride into
    the attention and MLP layers as ``prenorm`` (the kernel mode folds them
    into the q|k, v and up GEMMs' prologues). ``tp``: a tensor-parallel
    rank's split of the block."""
    a = _attention(cfg, p["attn"], h, tp=tp, causal=False, mode=mode,
                   use_rope=False, prenorm=norm_params(p, "ln1"),
                   qkv_plan=qkv_plan)
    h = h + a
    return _mlp(cfg, p["mlp"], h, tp=tp, mode=mode, residual=h,
                prenorm=norm_params(p, "ln2"), auto=qkv_plan == "auto")


def encode(cfg, params, enc_embeds, *, mode: str = "reference",
           qkv_plan: str = "rope_fused", remat: bool = False, tp=None):
    """enc_embeds: (B, S_enc, D) stub-frontend output -> (B, S_enc, D). The
    sinusoidal table is added in the compute type, both addends cast first,
    as the reference does. ``remat``: each block recomputed in the
    backward."""
    cd = dtype_of(cfg.compute_dtype)
    s = enc_embeds.shape[1]
    x = enc_embeds.to(cd) + sinusoidal_positions(
        s, cfg.d_model, enc_embeds.device).to(cd)
    block = functools.partial(encoder_block, cfg, mode=mode,
                              qkv_plan=qkv_plan, tp=tp)
    if remat:
        block = _remat(cfg, block)
    for p in unstack_layers(params["enc"], cfg.encoder_layers):
        x = block(p, x)
    return apply_norm(cfg, x, params, "enc_final_norm")


def _dec_block(cfg, p, x, enc_out, *, mode: str = "reference",
               qkv_plan: str = "rope_fused", tp=None):
    a = _attention(cfg, p["attn"], x, tp=tp, causal=True, mode=mode,
                   use_rope=False, prenorm=norm_params(p, "ln1"),
                   qkv_plan=qkv_plan)
    x = x + a
    c = _attention(cfg, p["xattn"], x, tp=tp, causal=False,
                   kv_input=enc_out, mode=mode, use_rope=False,
                   prenorm=norm_params(p, "lnx"))
    x = x + c
    return _mlp(cfg, p["mlp"], x, tp=tp, mode=mode, residual=x,
                prenorm=norm_params(p, "ln2"), auto=qkv_plan == "auto")


def _embed_tokens(cfg, params, tokens, tp=None):
    """Token embeddings plus the learned positions [0, S)."""
    cd = dtype_of(cfg.compute_dtype)
    return lookup(params["embed"], tokens, tp).to(cd) + \
        params["dec_pos"][:tokens.shape[1]].to(cd)


def _logits(cfg, params, x, tp=None):
    """The tied head's fp32 logits of the final norm of ``x``; on a
    tensor-parallel rank whose table holds vocab rows the rank's columns,
    the replicated norm entering through f."""
    x = apply_norm(cfg, x, params, "final_norm").float()
    if _vocab_split(cfg, tp):
        x = tp.f(x)
    return x @ params["embed"].T.float()


def encdec_forward(cfg, params, batch, *, mode: str = "reference",
                   qkv_plan: str = "rope_fused", remat: bool = False,
                   tp=None):
    """batch: {'encoder_embeds': (B, S_enc, D), 'inputs': (B, S)} -> logits
    (B, S, V) fp32; with ``remat`` every encoder and decoder block is
    recomputed in the backward. (The reference also returns an auxiliary
    loss of 0.) ``tp``: ``params`` are a tensor-parallel rank's blocks, the
    logits its vocab columns where the table's rows are split."""
    params = cast_params(params, dtype_of(cfg.compute_dtype))
    enc_out = encode(cfg, params, batch["encoder_embeds"], mode=mode,
                     qkv_plan=qkv_plan, remat=remat, tp=tp)
    x = _embed_tokens(cfg, params, batch["inputs"], tp)
    block = functools.partial(_dec_block, cfg, mode=mode, qkv_plan=qkv_plan,
                              tp=tp)
    if remat:
        block = _remat(cfg, block)
    for p in unstack_layers(params["dec"], cfg.num_layers):
        x = block(p, x, enc_out)
    return _logits(cfg, params, x, tp)


def encdec_loss(cfg, params, batch, *, mode: str = "reference",
                remat: bool = True, qkv_plan: str = "rope_fused", tp=None):
    """(loss, {"ce", "aux"}): the masked mean cross entropy of the batch
    {"encoder_embeds", "inputs", "targets"[, "loss_mask"]}; aux is 0.
    ``tp``: replicated over 'model' (the vocab-parallel cross entropy where
    the head is split)."""
    logits = encdec_forward(cfg, params, batch, mode=mode, qkv_plan=qkv_plan,
                            remat=remat, tp=tp)
    ce = cross_entropy_loss(logits, batch["targets"], batch.get("loss_mask"),
                            tp=tp if _vocab_split(cfg, tp) else None)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=logits.device)}


# ---------------------------------------------------------------------------
# Serving: the encoder runs once; the decoder's self k/v grow, the cross
# k/v are static.
# ---------------------------------------------------------------------------

def encdec_init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """{"self": {"k", "v"} (L, B, Hkv, max_len, hd), "cross": {"k", "v"}
    (L, B, Hkv, encoder_seq, hd)}, zeroed, in the compute type."""
    dtype = dtype_of(cfg.compute_dtype)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, cfg.encoder_seq,
             cfg.head_dim)
    return {"self": init_attn_cache(cfg, batch, max_len, None, dtype, device,
                                    layers=cfg.num_layers),
            "cross": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}}


def _layer_caches(cache, i: int) -> tuple:
    """Layer ``i``'s (self k, self v, cross k, cross v): views, so in-place
    writes land in the stacks."""
    return (cache["self"]["k"][i], cache["self"]["v"][i],
            cache["cross"]["k"][i], cache["cross"]["v"][i])


def encdec_prefill(cfg, params, batch, cache, *, mode: str = "reference",
                   qkv_plan: str = "rope_fused"):
    """Encode ``batch['encoder_embeds']`` and prefill the decoder on
    ``batch['inputs']`` (B, S). Fills ``cache`` in place: the self ring
    and each layer's cross k/v, into which the projections of the encoder
    output are written and from which the cross-attention reads them (one
    contiguous copy of those strided views). Returns (cache, last-position
    logits (B, V))."""
    enc_out = encode(cfg, params, batch["encoder_embeds"], mode=mode,
                     qkv_plan=qkv_plan)
    if enc_out.shape[1] != cfg.encoder_seq:
        raise ValueError(f"encoder_embeds hold {enc_out.shape[1]} frames; "
                         f"the cache holds encoder_seq {cfg.encoder_seq}")
    x = _embed_tokens(cfg, params, batch["inputs"])
    for i, p in enumerate(unstack_layers(params["dec"], cfg.num_layers)):
        k_self, v_self, k_cross, v_cross = _layer_caches(cache, i)
        q, k, v = project_qkv_heads(cfg, p["attn"], x, mode=mode,
                                    prenorm=norm_params(p, "ln1"),
                                    qkv_plan=qkv_plan, use_rope=False)
        o = attend(cfg, q, k, v, window=None, mode=mode, causal=True)
        prefill_attn_cache(k_self, v_self, k, v)
        x = x + _merge_heads(o) @ p["attn"]["wo"]
        hn = apply_norm(cfg, x, p, "lnx")
        qx, kx, vx = project_qkv(cfg, p["xattn"], hn, kv_input=enc_out)
        k_cross.copy_(kx)
        v_cross.copy_(vx)
        ox = attend(cfg, qx, k_cross, v_cross, window=None, mode=mode,
                    causal=False)
        x = x + _merge_heads(ox) @ p["xattn"]["wo"]
        x = mlp_forward(cfg, p["mlp"], x, mode=mode, residual=x,
                        prenorm=norm_params(p, "ln2"),
                        auto=qkv_plan == "auto")
    return cache, _logits(cfg, params, x[:, -1:, :])[:, 0]


def encdec_decode_step(cfg, params, token, cache, pos, *,
                       mode: str = "reference",
                       qkv_plan: str = "rope_fused"):
    """token: (B, 1); pos: the position being written, a Python int or a
    one-element int64 tensor on the cache's device (what a captured step
    reads: the learned position is then gathered with ``index_select``;
    the same bits). Appends to the self ring in place and reads the cross
    cache. Returns (cache, logits (B, V))."""
    cd = dtype_of(cfg.compute_dtype)
    if torch.is_tensor(pos):
        row = params["dec_pos"].index_select(0, pos.reshape(1))
    else:
        row = params["dec_pos"][pos:pos + 1]
    x = params["embed"][token].to(cd) + row.to(cd)
    for i, p in enumerate(unstack_layers(params["dec"], cfg.num_layers)):
        k_self, v_self, k_cross, v_cross = _layer_caches(cache, i)
        hn = apply_norm(cfg, x, p, "ln1")
        x = x + decode_attention_layer(cfg, p["attn"], hn, k_self, v_self,
                                       pos, use_rope=False, mode=mode)
        hn = apply_norm(cfg, x, p, "lnx")
        x = x + decode_attention_layer(cfg, p["xattn"], hn, k_cross, v_cross,
                                       pos, cross=True, update_cache=False,
                                       use_rope=False, mode=mode)
        x = mlp_forward(cfg, p["mlp"], x, mode=mode, residual=x,
                        prenorm=norm_params(p, "ln2"),
                        auto=qkv_plan == "auto")
    return cache, _logits(cfg, params, x)[:, 0]

