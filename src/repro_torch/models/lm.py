"""Decoder-only LM: embedding, a stack of attention blocks whose FFN is a
dense MLP ('attn') or a mixture of experts ('moe'), tied or untied logits;
full-sequence forward, prefill and one-token decode over a contiguous
cache, and prefill, chunked prefill and 1- or T-token decode over a paged
pool.

Layer parameters are stacked with a leading layer axis (the reference's
scan layout, same keys and shapes); a Python loop over layers takes the
place of ``lax.scan``. Serving keeps one copy of the parameters, cast once
to the compute type when they are made (``Model.init``,
``params_from_numpy``); training keeps fp32 masters, and the full-sequence
forward casts them (``cast_params``, as the reference does on every call),
so the cast's backward hands fp32 grads to the optimizer. With ``remat``
each block runs under ``torch.utils.checkpoint`` per ``cfg.remat_policy``
(:func:`_remat`). With ``cfg.ce_chunk`` the loss takes the cross entropy
chunk by chunk along the sequence (:func:`_chunked_ce`), so the (B, S, V)
fp32 logits never exist at once. The port runs a uniform stack of 'attn'
or of 'moe' blocks; any other block kind, and a mixed pattern, raises.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.device import dtype_of
from repro_torch.kernels.attention import attention_decode_paged
from .attention import (attend, attn_defs, decode_attention_layer,
                        init_attn_cache, init_paged_attn_cache,
                        paged_decode_attention_layer, paged_prefill_attn_cache,
                        prefill_attn_cache, project_qkv_heads, _merge_heads,
                        attention_layer)
from .common import (ParamDef, apply_norm, cast_params, cross_entropy_loss,
                     mlp_defs, mlp_forward, norm_defs, norm_params, tree_map)
from .moe import moe_defs, moe_forward


def check_supported(cfg) -> None:
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if len(kinds) > 1:
        raise NotImplementedError(
            f"{cfg.name}: mixed block pattern {tuple(cfg.block_pattern)}; the "
            "port runs a uniform ('attn',) or ('moe',) stack. The interleaved "
            "blocks_0/blocks_1 layout (llama4-maverick's ('attn', 'moe')) is "
            "ROADMAP Queue A item 4's next model")
    if not kinds <= {"attn", "moe"}:
        raise NotImplementedError(
            f"{cfg.name}: the port runs 'attn' and 'moe' blocks only, got "
            f"{sorted(kinds)}")
    if "moe" in kinds and cfg.moe is None:
        raise ValueError(f"{cfg.name}: 'moe' blocks need cfg.moe")
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
    if cfg.layer_kind(0) == "moe":
        defs.update(moe_defs(cfg, "blocks/moe", stack=n))
    else:
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


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(cfg, params, x, head=None):
    """fp32 logits of the final norm of ``x``; ``head``: the (d, V) head
    already in fp32, where the caller made it once for many calls."""
    x = apply_norm(cfg, x, params, "final_norm")
    if head is None:
        head = _head(cfg, params).float()
    logits = x.float() @ head
    if cfg.padded_vocab() != cfg.vocab_size:
        # the padding columns carry no probability mass
        pad = torch.arange(cfg.padded_vocab(), device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits / cfg.logit_scale_div


def _ffn(cfg, p, x, *, mode: str):
    """The block's FFN on the stream ``x`` after attention's residual, by
    block kind (the FFN's params: "mlp" or "moe"), ln2 riding in as
    ``prenorm``: the dense MLP, ``x + residual_scale * mlp(x)`` (in kernel
    mode the residual rides in the down GEMM's store), or the MoE FFN, added
    as ``x + residual_scale * m``. Returns (x, the MoE's aux or None)."""
    rs = cfg.residual_scale
    if "moe" in p:
        m, aux = moe_forward(cfg, p["moe"], x, mode=mode,
                             prenorm=norm_params(p, "ln2"))
        return x + rs * m, aux
    return mlp_forward(cfg, p["mlp"], x, mode=mode, residual=x,
                       residual_scale=rs,
                       prenorm=norm_params(p, "ln2")), None


def block_forward(cfg, p, x, *, positions, mode: str = "reference",
                  qkv_plan: str = "rope_fused"):
    """One block on the pre-norm residual stream ``x``: ln1 and ln2 ride
    into the attention and FFN layers as ``prenorm``; ``qkv_plan`` is the
    rung of the QKV ladder ('kernel' mode). Returns (x, the MoE's
    load-balancing loss, or None for a dense block)."""
    a = attention_layer(cfg, p["attn"], x, window=cfg.attn_window,
                        positions=positions, mode=mode,
                        prenorm=norm_params(p, "ln1"), qkv_plan=qkv_plan)
    return _ffn(cfg, p, x + cfg.residual_scale * a, mode=mode)


def unstack_layers(blocks, n: int) -> list:
    """Every layer's parameters as views of the stacked block params, made
    by one ``unbind`` per leaf: its backward stacks the layers' grads once,
    where indexing each layer would add a zero-filled full-size buffer per
    layer."""
    per_leaf = tree_map(lambda x: x.unbind(0), blocks)
    return [tree_map(lambda t, i=i: t[i], per_leaf) for i in range(n)]


# products without batch dims, whose outputs remat_policy="dots" keeps: the
# plain path's (aten.mm, aten.addmm) and the forward GEMM kernel's op
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.repro_torch.gemm_fused.default)


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _SAVED_PRODUCTS:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` recomputed in the backward, per ``cfg.remat_policy``: "full"
    recomputes all of it; "dots" keeps the outputs of the matrix products
    without batch dims (the reference's
    ``checkpoint_dots_with_no_batch_dims``): the plain products and the
    forward GEMM kernel, whose launch the policy sees as the custom op
    ``repro_torch::gemm_fused``; it recomputes the rest, attention (a
    product with batch dims, or the flash kernel) included."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)

    def run(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)
    return run


def lm_hidden(cfg, params, tokens, *, mode: str = "reference",
              remat: bool = False, qkv_plan: str = "rope_fused"):
    """tokens: (B, S) -> (the last block's output (B, S, d), the params
    cast to the compute type, the layers' summed MoE auxiliary loss in fp32,
    0 for dense blocks), so the loss reuses the cast."""
    params = cast_params(params, dtype_of(cfg.compute_dtype))
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    block = functools.partial(block_forward, cfg, positions=positions,
                              mode=mode, qkv_plan=qkv_plan)
    if remat:
        block = _remat(cfg, block)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in unstack_layers(params["blocks"], cfg.num_layers):
        x, a = block(p, x)
        if a is not None:
            aux = aux + a
    return x, params, aux


def lm_forward(cfg, params, tokens, *, mode: str = "reference",
               remat: bool = False, qkv_plan: str = "rope_fused"):
    """tokens: (B, S) -> logits (B, S, V) fp32. (The reference also returns
    the MoE auxiliary loss: :func:`lm_hidden` has it.)"""
    x, cast, _ = lm_hidden(cfg, params, tokens, mode=mode, remat=remat,
                           qkv_plan=qkv_plan)
    return _logits(cfg, cast, x)


def _chunked_ce(cfg, params, hidden, targets, mask, chunk: int):
    """The masked mean cross entropy, ``chunk`` positions of the sequence
    at a time (halved until it divides S): each chunk's fp32 logits are made
    under a non-reentrant checkpoint, so they live only while that chunk
    runs, in the backward too. ``params``: the compute-type cast; the head
    is cast to fp32 once and handed to every chunk as an input, so its grad
    is summed over the chunks in fp32."""
    s = hidden.shape[1]
    while s % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=hidden.device)
    norm = {k: v for k, v in params.items() if k.startswith("final_norm")}
    head = _head(cfg, params).float()

    def body(h, t, m, head, norm):
        logits = _logits(cfg, norm, h, head)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        mf = m.float()
        return torch.sum((lse - gold) * mf), torch.sum(mf)

    nll = msum = 0.0
    for i in range(0, s, chunk):
        part = slice(i, i + chunk)
        n_, m_ = torch.utils.checkpoint.checkpoint(
            body, hidden[:, part], targets[:, part], mask[:, part], head,
            norm, use_reentrant=False)
        nll, msum = nll + n_, msum + m_
    return nll / torch.clamp(msum, min=1.0)


def lm_loss(cfg, params, batch, *, mode: str = "reference", remat: bool = True,
            aux_weight: float = 0.01, qkv_plan: str = "rope_fused"):
    """(loss, {"ce", "aux"}): ``ce + aux_weight * aux``, the masked mean
    cross entropy of the batch {"inputs", "targets"[, "loss_mask"]} (over
    ``cfg.ce_chunk``-position chunks where that is set) and the layers'
    summed MoE load-balancing loss (0 for dense blocks)."""
    hidden, cast, aux = lm_hidden(cfg, params, batch["inputs"], mode=mode,
                                  remat=remat, qkv_plan=qkv_plan)
    if cfg.ce_chunk:
        ce = _chunked_ce(cfg, cast, hidden, batch["targets"],
                         batch.get("loss_mask"), cfg.ce_chunk)
    else:
        ce = cross_entropy_loss(_logits(cfg, cast, hidden), batch["targets"],
                                batch.get("loss_mask"))
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def lm_init_cache(cfg, batch: int, max_len: int, device) -> dict:
    return init_attn_cache(cfg, batch, max_len, cfg.attn_window,
                           dtype_of(cfg.compute_dtype), device,
                           layers=cfg.num_layers)


def block_prefill(cfg, p, x, k_cache, v_cache, *, positions,
                  mode: str = "reference", qkv_plan: str = "rope_fused"):
    """Full-sequence block that also fills its layer's cache (in place)."""
    q, k, v = project_qkv_heads(cfg, p["attn"], x, positions, mode=mode,
                                prenorm=norm_params(p, "ln1"),
                                qkv_plan=qkv_plan)
    o = attend(cfg, q, k, v, window=cfg.attn_window, mode=mode)
    prefill_attn_cache(k_cache, v_cache, k, v)
    x = x + cfg.residual_scale * (_merge_heads(o) @ p["attn"]["wo"])
    return _ffn(cfg, p, x, mode=mode)[0]


def block_decode(cfg, p, x, k_cache, v_cache, pos, *,
                 mode: str = "reference"):
    rs = cfg.residual_scale
    h = apply_norm(cfg, x, p, "ln1")
    a = decode_attention_layer(cfg, p["attn"], h, k_cache, v_cache, pos,
                               window=cfg.attn_window, mode=mode)
    return _ffn(cfg, p, x + rs * a, mode=mode)[0]


def lm_prefill(cfg, params, tokens, cache, *, mode: str = "reference",
               qkv_plan: str = "rope_fused"):
    """Fills ``cache`` in place. Returns (cache, last-position logits
    (B, V))."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        x = block_prefill(cfg, layer_params(params, i), x, cache["k"][i],
                          cache["v"][i], positions=positions, mode=mode,
                          qkv_plan=qkv_plan)
    return cache, _logits(cfg, params, x[:, -1:, :])[:, 0]


def lm_decode_step(cfg, params, token, cache, pos, *,
                   mode: str = "reference"):
    """token: (B, 1); pos: the position being written, a Python int or a
    one-element int64 tensor on the cache's device (what a captured step
    reads; the same bits). Updates ``cache`` in place. Returns (cache,
    logits (B, V))."""
    x = _embed(cfg, params, token)
    for i in range(cfg.num_layers):
        x = block_decode(cfg, layer_params(params, i), x, cache["k"][i],
                         cache["v"][i], pos, mode=mode)
    return cache, _logits(cfg, params, x)[:, 0]


# ---------------------------------------------------------------------------
# Paged decode path (shared page pool)
# ---------------------------------------------------------------------------

def lm_init_paged_cache(cfg, batch_slots: int, n_pages: int, page_size: int,
                        device) -> dict:
    """Stacked {"k_pages", "v_pages"}, each (L, P, Hkv, page, hd): the
    reference's scan-stacked layout, so the pools compare directly.
    ``batch_slots`` is taken for the reference's signature: attention
    blocks keep no per-slot state."""
    del batch_slots
    pool = init_paged_attn_cache(cfg, n_pages, page_size,
                                 dtype_of(cfg.compute_dtype), device)
    return {k: v[None].repeat(cfg.num_layers, 1, 1, 1, 1)
            for k, v in pool.items()}


def _layer_cache(cache, i: int) -> dict:
    """Layer ``i``'s pools: views, so in-place writes land in the stack."""
    return {"k_pages": cache["k_pages"][i], "v_pages": cache["v_pages"][i]}


def _attention_only(cfg) -> bool:
    """True when every layer is attention-family. The serving fast paths
    (chunked prefill, prefix reuse, multi-token verify) rely on a KV cache of
    position-addressable pages; recurrent state cannot be re-entered."""
    return all(cfg.layer_kind(i) in ("attn", "local", "moe")
               for i in range(cfg.num_layers))


def _int32(x, device):
    """A contiguous int32 tensor on ``device`` (one upload for a host array)."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).contiguous()


def block_prefill_paged(cfg, p, x, cache, *, page_rows, positions,
                        mode: str = "reference", qkv_plan: str = "rope_fused"):
    """Single-sequence (B = 1) prefill block whose rotated k/v land in the
    sequence's pages (in place)."""
    q, k, v = project_qkv_heads(cfg, p["attn"], x, positions, mode=mode,
                                prenorm=norm_params(p, "ln1"),
                                qkv_plan=qkv_plan)
    o = attend(cfg, q, k, v, window=cfg.attn_window, mode=mode)
    paged_prefill_attn_cache(cfg, cache, k, v, page_rows)
    x = x + cfg.residual_scale * (_merge_heads(o) @ p["attn"]["wo"])
    return _ffn(cfg, p, x, mode=mode)[0]


def lm_prefill_paged(cfg, params, tokens, cache, page_rows, slot: int,
                     true_len: int, *, mode: str = "reference",
                     qkv_plan: str = "rope_fused"):
    """Prefill ONE sequence into the shared paged cache (in place).

    tokens: (1, S); ``page_rows``: (max_pages,) page-table row; ``slot`` is
    taken for the reference's signature (only recurrent layers keep slot
    state). S may exceed ``true_len`` (a padded bucket): k/v past it stay
    masked by the length until overwritten. Returns (cache, logits (1, V)
    at position ``true_len - 1``)."""
    del slot
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        x = block_prefill_paged(cfg, layer_params(params, i), x,
                                _layer_cache(cache, i), page_rows=page_rows,
                                positions=positions, mode=mode,
                                qkv_plan=qkv_plan)
    return cache, _logits(cfg, params, x[:, true_len - 1:true_len])[:, 0]


def block_prefill_paged_chunk(cfg, p, x, cache, *, page_rows, table, start,
                              length, positions, mode: str = "reference",
                              qkv_plan: str = "rope_fused"):
    """One layer of chunked prefill: the chunk's k/v land in the sequence's
    pages at page offset ``start // page_size``, and its queries attend to
    everything already in the pages (earlier chunks and this one) through
    the multi-token paged-decode mask. ``table`` (1, MP) and ``length`` (1,)
    are the row and ``start + C`` as int32 tensors on x's device."""
    q, k, v = project_qkv_heads(cfg, p["attn"], x, positions, mode=mode,
                                prenorm=norm_params(p, "ln1"),
                                qkv_plan=qkv_plan)
    page_size = cache["k_pages"].shape[2]
    paged_prefill_attn_cache(cfg, cache, k, v, page_rows,
                             start_page=start // page_size)
    o = attention_decode_paged(q, cache["k_pages"], cache["v_pages"], table,
                               length, window=cfg.attn_window,
                               softcap=cfg.attn_logit_softcap, mode=mode)
    x = x + cfg.residual_scale * (_merge_heads(o.to(x.dtype))
                                  @ p["attn"]["wo"])
    return _ffn(cfg, p, x, mode=mode)[0]


def lm_prefill_paged_chunk(cfg, params, tokens, cache, page_rows, start: int,
                           last_index: int, *, mode: str = "reference",
                           qkv_plan: str = "rope_fused"):
    """Prefill ONE chunk of one sequence into the shared paged cache.

    tokens: (1, C), C a whole number of pages; ``start``: the chunk's first
    absolute position (a page multiple); ``last_index``: the final true
    token within the chunk (its logits seed sampling; meaningful on the
    last chunk only). Prefix-cache admission reuses it with ``start`` = the
    matched prefix length. Returns (cache, logits (1, V))."""
    if not _attention_only(cfg):
        raise ValueError(
            "chunked paged prefill requires an attention-only stack; "
            f"{cfg.name} has recurrent layers; use lm_prefill_paged")
    x = _embed(cfg, params, tokens)
    c = tokens.shape[1]
    positions = start + torch.arange(c, device=x.device)
    table = _int32(page_rows, x.device)[None, :]
    length = _int32([start + c], x.device)
    for i in range(cfg.num_layers):
        x = block_prefill_paged_chunk(
            cfg, layer_params(params, i), x, _layer_cache(cache, i),
            page_rows=page_rows, table=table, start=start, length=length,
            positions=positions, mode=mode, qkv_plan=qkv_plan)
    return cache, _logits(cfg, params,
                          x[:, last_index:last_index + 1])[:, 0]


def block_decode_paged(cfg, p, x, cache, page_table, lengths, *,
                       mode: str = "reference"):
    rs = cfg.residual_scale
    h = apply_norm(cfg, x, p, "ln1")
    a = paged_decode_attention_layer(cfg, p["attn"], h, cache, page_table,
                                     lengths, window=cfg.attn_window,
                                     mode=mode)
    return _ffn(cfg, p, x + rs * a, mode=mode)[0]


def lm_decode_step_paged(cfg, params, token, cache, page_table, lengths, *,
                         mode: str = "reference"):
    """One decode step for every batch slot over the paged cache (in place).

    token: (B, T). T == 1 is plain decode (each slot's token lands at
    position lengths[b]; logits (B, V)); T > 1 is the speculative verify
    step (token t lands at lengths[b] + t; logits (B, T, V)).
    ``page_table`` (B, MP) and ``lengths`` (B,): host arrays or tensors,
    moved to the model's device once per call. Inactive slots decode
    against the null page and produce ignorable logits."""
    if token.shape[1] > 1 and not _attention_only(cfg):
        raise ValueError(
            "multi-token paged decode (speculative verify) requires an "
            f"attention-only stack; {cfg.name} has recurrent layers")
    x = _embed(cfg, params, token)
    page_table = _int32(page_table, x.device)
    lengths = _int32(lengths, x.device)
    for i in range(cfg.num_layers):
        x = block_decode_paged(cfg, layer_params(params, i), x,
                               _layer_cache(cache, i), page_table, lengths,
                               mode=mode)
    logits = _logits(cfg, params, x)
    if token.shape[1] > 1:
        return cache, logits          # (B, T, V): speculative verify
    return cache, logits[:, 0]
