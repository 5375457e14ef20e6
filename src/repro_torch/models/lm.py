"""Decoder-only LM: embedding, a stack of blocks, tied or untied logits;
full-sequence forward, prefill and one-token decode over a contiguous
cache, and prefill, chunked prefill and 1- or T-token decode over a paged
pool. A block is attention with a dense MLP ('attn'), attention with a
mixture of experts ('moe'), attention in the RG-LRU config's local window
with an MLP ('local'), the RG-LRU recurrent block with an MLP ('rg'), or
Mamba2's SSD block with no MLP ('ssm').

Parameters follow the reference's layout (:func:`_layout`, the same keys
and shapes): a uniform stack under ``blocks`` with a leading layer axis; a
mixed pattern that divides the depth under ``blocks_{i}``, one stack per
pattern position with a leading group axis (llama4-maverick's dense and
MoE layers, ('attn', 'moe'), under ``blocks_0`` and ``blocks_1``);
otherwise one subtree per layer, ``layer_{i:03d}`` (recurrentgemma-2b's
26 = 8 x 3 + 2 layers). A Python loop over layers takes the place of
``lax.scan``. The caches have the same layout, a block kind's own in each
entry: a (ring) KV cache or a page pool for attention, the per-slot
recurrent state ({"conv", "h"} for 'rg', {"conv", "state"} for 'ssm'; the
paged cache keeps it per batch slot). Serving keeps one copy of the
parameters, cast once to the compute type when they are made
(``Model.init``, ``params_from_numpy``); training keeps fp32 masters, and
the full-sequence forward casts them (``cast_params``, as the reference
does on every call), so the cast's backward hands fp32 grads to the
optimizer. With ``remat`` each block runs under ``torch.utils.checkpoint``
per ``cfg.remat_policy`` (:func:`_remat`). With ``cfg.ce_chunk`` the loss
takes the cross entropy chunk by chunk along the sequence
(:func:`_chunked_ce`), so the (B, S, V) fp32 logits never exist at once.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.configs import DECODER_FAMILIES
from repro_torch.device import dtype_of
from repro_torch.kernels.attention import attention_decode_paged
from .attention import (attend, attn_defs, decode_attention_layer,
                        init_attn_cache, init_paged_attn_cache,
                        paged_decode_attention_layer, paged_prefill_attn_cache,
                        prefill_attn_cache, project_qkv_heads, _merge_heads,
                        attention_layer, split_attention_layer)
from .common import (ParamDef, apply_norm, cast_params, cross_entropy_loss,
                     mlp_defs, mlp_forward, nll_terms, norm_defs, norm_params,
                     split_mlp_forward, tree_map)
from .moe import moe_defs, moe_forward, resolve_impl
from .rglru import (init_rglru_cache, rglru_decode_step, rglru_defs,
                    rglru_forward, rglru_prefill, split_rglru_forward)
from .ssm import (init_ssm_cache, ssm_decode_step, ssm_defs, ssm_forward,
                  ssm_prefill, split_ssm_forward)

ATTENTION_KINDS = ("attn", "local", "moe")
# a recurrent block kind -> the key of its core's params, its core's
# (full-sequence forward, prefill, decode step, full-sequence forward on a
# tensor-parallel rank) and its cache's constructor
RECURRENT = {
    "rg": ("rec", (rglru_forward, rglru_prefill, rglru_decode_step,
                   split_rglru_forward), init_rglru_cache),
    "ssm": ("ssm", (ssm_forward, ssm_prefill, ssm_decode_step,
                    split_ssm_forward), init_ssm_cache),
}
BLOCK_KINDS = ATTENTION_KINDS + tuple(RECURRENT)
FORWARD, PREFILL, DECODE, SPLIT = range(4)


def check_supported(cfg) -> None:
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if not kinds <= set(BLOCK_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: the port runs {BLOCK_KINDS} blocks, got "
            f"{sorted(kinds)}")
    if "moe" in kinds and cfg.moe is None:
        raise ValueError(f"{cfg.name}: 'moe' blocks need cfg.moe")
    if "rg" in kinds and cfg.rglru is None:
        raise ValueError(f"{cfg.name}: 'rg' blocks need cfg.rglru")
    if "ssm" in kinds and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: 'ssm' blocks need cfg.ssm")
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r}; the "
                                  "port runs decoder-only LMs ('lm') and "
                                  "their vision-language form ('vlm')")


def _layout(cfg) -> tuple:
    """How layers are stacked, as the reference's: ('scan', pattern,
    n_groups), layers grouped by the block pattern (pattern length 1 is the
    uniform stack), or ('loop',) where the pattern does not divide the
    depth."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    if len(set(kinds)) == 1:
        return ("scan", (kinds[0],), cfg.num_layers)
    pat = tuple(cfg.block_pattern)
    if cfg.num_layers % len(pat) == 0:
        return ("scan", pat, cfg.num_layers // len(pat))
    return ("loop",)


def layer_slots(cfg) -> list:
    """(kind, key, index) of every layer: its block kind, the key of its
    parameter and cache subtree ("blocks", "blocks_{i}" or
    "layer_{i:03d}") and its index into that subtree's stack (None for a
    per-layer subtree)."""
    layout = _layout(cfg)
    if layout[0] == "loop":
        return [(cfg.layer_kind(i), f"layer_{i:03d}", None)
                for i in range(cfg.num_layers)]
    _, pattern, _ = layout
    if len(pattern) == 1:
        return [(pattern[0], "blocks", i) for i in range(cfg.num_layers)]
    n = len(pattern)
    return [(pattern[i % n], f"blocks_{i % n}", i // n)
            for i in range(cfg.num_layers)]


def _block_window(cfg, kind: str):
    """The attention window of a block kind: a 'local' block's is the
    RG-LRU config's ``local_window``."""
    if kind == "local":
        return (cfg.rglru.local_window if cfg.rglru is not None
                else cfg.attn_window)
    return cfg.attn_window


def block_defs(cfg, kind: str, prefix: str, *, stack=None) -> dict:
    """A block's parameters: its core (attention, the RG-LRU or the SSD
    mixer), ln1 and, but for an 'ssm' block, ln2 and the FFN."""
    defs = {}
    if kind == "ssm":
        defs.update(ssm_defs(cfg, f"{prefix}/ssm", stack=stack))
        defs.update(norm_defs(cfg, f"{prefix}/ln1", stack=stack))
        return defs
    if kind in ATTENTION_KINDS:
        defs.update(attn_defs(cfg, f"{prefix}/attn", stack=stack))
    else:
        defs.update(rglru_defs(cfg, f"{prefix}/rec", stack=stack))
    defs.update(norm_defs(cfg, f"{prefix}/ln1", stack=stack))
    defs.update(norm_defs(cfg, f"{prefix}/ln2", stack=stack))
    if kind == "moe":
        defs.update(moe_defs(cfg, f"{prefix}/moe", stack=stack))
    else:
        defs.update(mlp_defs(cfg, f"{prefix}/mlp", stack=stack))
    return defs


def lm_param_defs(cfg) -> dict:
    check_supported(cfg)
    d, v, dt = cfg.d_model, cfg.padded_vocab(), cfg.param_dtype
    # 'embed' sharding d-shards the table (the model axis on its d dim)
    emb_axes = (("vocab", "embed") if cfg.embed_shard == "vocab"
                else (None, "ffn"))
    if cfg.tie_embeddings and cfg.embed_shard != "vocab":
        raise ValueError("embed d-sharding requires an untied LM head "
                         "(tied logits would contract over a sharded dim)")
    defs = {"embed": ParamDef((v, d), emb_axes, dtype=dt)}
    layout = _layout(cfg)
    if layout[0] == "scan":
        _, pattern, n_groups = layout
        if len(pattern) == 1:
            defs.update(block_defs(cfg, pattern[0], "blocks", stack=n_groups))
        else:
            for i, kind in enumerate(pattern):
                defs.update(block_defs(cfg, kind, f"blocks_{i}",
                                       stack=n_groups))
    else:
        for i in range(cfg.num_layers):
            defs.update(block_defs(cfg, cfg.layer_kind(i), f"layer_{i:03d}"))
    defs.update(norm_defs(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"), dtype=dt)
    return defs


def _entry(tree, key: str, index):
    """One layer's entry of a parameter or cache tree: views into a stack
    (in-place writes land in it), or the layer's own subtree. A uniform
    stack's cache is the tree itself."""
    sub = tree[key] if key in tree else tree
    if index is None:
        return sub
    return tree_map(lambda x: x[index], sub)


def _layers(cfg, params) -> list:
    """(kind, params) of every layer."""
    return [(kind, _entry(params, key, index))
            for kind, key, index in layer_slots(cfg)]


def lookup(table, tokens, tp=None):
    """The rows of ``table`` at ``tokens``. On a tensor-parallel rank
    (``tp``) whose table holds vocab rows ``rank * V_loc ..`` each rank
    looks up the tokens it holds, zeros elsewhere, and the ranks' rows are
    summed (g); a table d-sharded over 'model' (``embed_shard="embed"``)
    is looked up in the rank's columns and all-gathered along d."""
    if tp is not None and tp.vocab_rows:
        rows = tp.vocab_rows
        local = tokens - tp.rank * rows
        mine = (local >= 0) & (local < rows)
        return tp.g(torch.where(mine[..., None],
                                table[local.clamp(0, rows - 1)], 0.0))
    if tp is not None and tp.held("embed") == 1:
        return tp.gather(table[tokens], tokens.dim(), "own")
    return table[tokens]


def _embed(cfg, params, tokens, tp=None):
    """The embedded tokens (:func:`lookup`, ``tp`` a tensor-parallel
    rank's)."""
    x = lookup(params["embed"], tokens, tp)
    return x.to(dtype_of(cfg.compute_dtype)) * cfg.emb_scale


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _vocab_split(cfg, tp) -> bool:
    """Whether the rank's head holds a block of the vocab columns."""
    return tp is not None and bool(tp.vocab_rows if cfg.tie_embeddings
                                   else tp.head_cols)


def _logits(cfg, params, x, head=None, tp=None):
    """fp32 logits of the final norm of ``x``; ``head``: the (d, V) head
    already in fp32, where the caller made it once for many calls. On a
    tensor-parallel rank whose head holds vocab columns (``tp``) the
    rank's columns of the logits, the replicated norm entering through f
    and the padding masked by global column."""
    x = apply_norm(cfg, x, params, "final_norm")
    if head is None:
        head = _head(cfg, params).float()
    split = _vocab_split(cfg, tp)
    xf = tp.f(x.float()) if split else x.float()
    logits = xf @ head
    if cfg.padded_vocab() != cfg.vocab_size:
        # the padding columns carry no probability mass
        first = tp.rank * logits.shape[-1] if split else 0
        pad = torch.arange(first, first + logits.shape[-1],
                           device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits / cfg.logit_scale_div


def _ffn(cfg, p, x, *, mode: str, mesh=None, data_axes=("data",), tp=None,
         qkv_plan: str = "rope_fused"):
    """The block's FFN on the stream ``x`` after attention's (or the
    recurrence's) residual, by block kind (the FFN's params: "mlp" or
    "moe"), ln2 riding in as ``prenorm``: the dense MLP, ``x +
    residual_scale * mlp(x)`` (in kernel mode the residual rides in the
    down GEMM's store), or the MoE FFN, added as ``x + residual_scale *
    m``. On a tensor-parallel rank (``tp``) the MLP is
    ``split_mlp_forward`` and the experts are the rank's as its impl runs
    them. Under ``qkv_plan="auto"`` the MLP's and the experts' plans follow
    ``select_fusion``. Returns (x, the MoE's aux or None)."""
    rs = cfg.residual_scale
    auto = qkv_plan == "auto"
    if "moe" in p:
        moe_p = p["moe"]
        if tp is not None:
            moe_p = tp.moe_params(moe_p, resolve_impl(cfg, mesh))
        m, aux = moe_forward(cfg, moe_p, x, mode=mode, mesh=mesh,
                             data_axes=data_axes,
                             prenorm=norm_params(p, "ln2"), auto=auto)
        return x + rs * m, aux
    if tp is not None:
        return split_mlp_forward(cfg, p["mlp"], x, tp=tp, mode=mode,
                                 residual=x, residual_scale=rs,
                                 prenorm=norm_params(p, "ln2"),
                                 auto=auto), None
    return mlp_forward(cfg, p["mlp"], x, mode=mode, residual=x,
                       residual_scale=rs, prenorm=norm_params(p, "ln2"),
                       auto=auto), None


def _recurrent(cfg, p, x, kind: str, which: int, *args):
    """A recurrent block's core (``which`` of its ``RECURRENT`` functions:
    FORWARD, PREFILL, DECODE or SPLIT) on the standalone ln1 norm of ``x``
    (the reference keeps the norm outside the recurrent core)."""
    key, fns, _ = RECURRENT[kind]
    return fns[which](cfg, p[key], apply_norm(cfg, x, p, "ln1"), *args)


def _recurrent_rest(cfg, p, x, out, *, mode: str, mesh=None,
                    data_axes=("data",), tp=None,
                    qkv_plan: str = "rope_fused"):
    """The rest of a recurrent block after its core's ``out``: ``x +
    residual_scale * out``, then an 'rg' block's FFN (an 'ssm' block has
    none). Returns (x, None)."""
    x = x + cfg.residual_scale * out
    if "mlp" in p:
        return _ffn(cfg, p, x, mode=mode, mesh=mesh, data_axes=data_axes,
                    tp=tp, qkv_plan=qkv_plan)
    return x, None


def block_forward(cfg, p, x, *, positions, mode: str = "reference",
                  mesh=None, data_axes=("data",),
                  qkv_plan: str = "rope_fused", kind: str = "attn", tp=None):
    """One block of kind ``kind`` on the pre-norm residual stream ``x``:
    ln1 and ln2 ride into the attention and FFN layers as ``prenorm`` (an
    'rg' block norms ln1 standalone); ``qkv_plan`` is the rung of the QKV
    ladder ('kernel' mode). ``tp``: a tensor-parallel rank's split of the
    block (``distributed.tensor_parallel``; a recurrent core's SPLIT
    function). Returns (x, the MoE's load-balancing loss, or None)."""
    if tp is not None:
        if kind in RECURRENT:
            return _recurrent_rest(cfg, p, x,
                                   _recurrent(cfg, p, x, kind, SPLIT, tp),
                                   mode=mode, mesh=mesh, data_axes=data_axes,
                                   tp=tp, qkv_plan=qkv_plan)
        a = split_attention_layer(
            cfg, p["attn"], x, tp=tp, window=_block_window(cfg, kind),
            positions=positions, mode=mode, prenorm=norm_params(p, "ln1"),
            qkv_plan=qkv_plan)
        return _ffn(cfg, p, x + cfg.residual_scale * a, mode=mode,
                    mesh=mesh, data_axes=data_axes,
                    qkv_plan=qkv_plan, tp=tp)
    if kind in RECURRENT:
        return _recurrent_rest(cfg, p, x, _recurrent(cfg, p, x, kind,
                                                     FORWARD), mode=mode,
                               mesh=mesh, data_axes=data_axes,
                               qkv_plan=qkv_plan)
    a = attention_layer(cfg, p["attn"], x, window=_block_window(cfg, kind),
                        positions=positions, mode=mode,
                        prenorm=norm_params(p, "ln1"), qkv_plan=qkv_plan)
    return _ffn(cfg, p, x + cfg.residual_scale * a, mode=mode,
                mesh=mesh, data_axes=data_axes,
                qkv_plan=qkv_plan)


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


def _unstacked_layers(cfg, params) -> list:
    """(kind, params) of every layer, each stack unbound once per leaf
    (:func:`unstack_layers`) for training."""
    layout, slots = _layout(cfg), layer_slots(cfg)
    if layout[0] == "loop":
        return [(kind, params[key]) for kind, key, _ in slots]
    stacks = {key: unstack_layers(params[key], layout[2])
              for _, key, _ in slots}
    return [(kind, stacks[key][index]) for kind, key, index in slots]


def lm_blocks(cfg, params, x, *, mode: str = "reference",
              mesh=None, data_axes=("data",),
              remat: bool = False, qkv_plan: str = "rope_fused", tp=None):
    """Every block on the embedded stream ``x`` (B, S, d), at positions 0
    .. S - 1, causal; ``params`` cast to the compute type. Returns (the last
    block's output, the layers' summed MoE auxiliary loss in fp32, 0 for
    dense and recurrent blocks)."""
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = {}
    for kind, p in _unstacked_layers(cfg, params):
        if kind not in blocks:
            block = functools.partial(block_forward, cfg, positions=positions,
                                      mode=mode, mesh=mesh,
                                      data_axes=data_axes, qkv_plan=qkv_plan,
                                      kind=kind, tp=tp)
            blocks[kind] = _remat(cfg, block) if remat else block
        x, a = blocks[kind](p, x)
        if a is not None:
            aux = aux + a
    return x, aux


def lm_hidden(cfg, params, tokens, *, mode: str = "reference",
              mesh=None, data_axes=("data",),
              remat: bool = False, qkv_plan: str = "rope_fused", tp=None):
    """tokens: (B, S) -> (the last block's output (B, S, d), the params
    cast to the compute type, the layers' summed MoE auxiliary loss in fp32,
    0 for dense blocks), so the loss reuses the cast. ``tp``: the params
    are a tensor-parallel rank's blocks (``distributed.tensor_parallel``);
    the output is replicated over 'model'."""
    params = cast_params(params, dtype_of(cfg.compute_dtype))
    x, aux = lm_blocks(cfg, params, _embed(cfg, params, tokens, tp),
                       mode=mode, mesh=mesh, data_axes=data_axes,
                       remat=remat, qkv_plan=qkv_plan, tp=tp)
    return x, params, aux


def lm_forward(cfg, params, tokens, *, mode: str = "reference",
               mesh=None, data_axes=("data",),
               remat: bool = False, qkv_plan: str = "rope_fused"):
    """tokens: (B, S) -> logits (B, S, V) fp32. (The reference also returns
    the MoE auxiliary loss: :func:`lm_hidden` has it.)"""
    x, cast, _ = lm_hidden(cfg, params, tokens, mode=mode,
                           mesh=mesh, data_axes=data_axes, remat=remat,
                           qkv_plan=qkv_plan)
    return _logits(cfg, cast, x)


def _chunked_ce(cfg, params, hidden, targets, mask, chunk: int, tp=None):
    """The masked mean cross entropy, ``chunk`` positions of the sequence
    at a time (halved until it divides S): each chunk's fp32 logits are made
    under a non-reentrant checkpoint, so they live only while that chunk
    runs, in the backward too. ``params``: the compute-type cast; the head
    is cast to fp32 once and handed to every chunk as an input, so its grad
    is summed over the chunks in fp32. ``tp``: the vocab-parallel form
    (:func:`_logits`, ``common.nll_terms``)."""
    s = hidden.shape[1]
    while s % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=hidden.device)
    norm = {k: v for k, v in params.items() if k.startswith("final_norm")}
    head = _head(cfg, params).float()

    ctp = tp if _vocab_split(cfg, tp) else None

    def body(h, t, m, head, norm):
        logits = _logits(cfg, norm, h, head, tp)
        mf = m.float()
        return torch.sum(nll_terms(logits, t, tp=ctp) * mf), torch.sum(mf)

    nll = msum = 0.0
    for i in range(0, s, chunk):
        part = slice(i, i + chunk)
        n_, m_ = torch.utils.checkpoint.checkpoint(
            body, hidden[:, part], targets[:, part], mask[:, part], head,
            norm, use_reentrant=False)
        nll, msum = nll + n_, msum + m_
    return nll / torch.clamp(msum, min=1.0)


def lm_loss(cfg, params, batch, *, mode: str = "reference",
            mesh=None, data_axes=("data",), remat: bool = True,
            aux_weight: float = 0.01, qkv_plan: str = "rope_fused",
            tp=None):
    """(loss, {"ce", "aux"}): ``ce + aux_weight * aux``, the masked mean
    cross entropy of the batch {"inputs", "targets"[, "loss_mask"]} (over
    ``cfg.ce_chunk``-position chunks where that is set) and the layers'
    summed MoE load-balancing loss (0 for dense blocks). ``tp``: ``params``
    are a tensor-parallel rank's blocks; the loss is replicated over
    'model' (the vocab-parallel cross entropy where the head is split)."""
    hidden, cast, aux = lm_hidden(cfg, params, batch["inputs"], mode=mode,
                                  mesh=mesh, data_axes=data_axes,
                                  remat=remat, qkv_plan=qkv_plan, tp=tp)
    if cfg.ce_chunk:
        ce = _chunked_ce(cfg, cast, hidden, batch["targets"],
                         batch.get("loss_mask"), cfg.ce_chunk, tp)
    else:
        ce = cross_entropy_loss(
            _logits(cfg, cast, hidden, tp=tp), batch["targets"],
            batch.get("loss_mask"), tp=tp if _vocab_split(cfg, tp) else None)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Caches: one entry per parameter subtree, of its block kind
# ---------------------------------------------------------------------------

def _init_caches(cfg, make) -> dict:
    """The cache tree in the parameters' layout: ``make(kind, stack)`` is
    one block kind's cache with a leading ``stack`` dim (None: none)."""
    layout = _layout(cfg)
    if layout[0] == "scan":
        _, pattern, n_groups = layout
        if len(pattern) == 1:
            return make(pattern[0], n_groups)
        return {f"blocks_{i}": make(kind, n_groups)
                for i, kind in enumerate(pattern)}
    return {f"layer_{i:03d}": make(cfg.layer_kind(i), None)
            for i in range(cfg.num_layers)}


def _layer_caches(cfg, cache) -> list:
    """Every layer's cache entry: views into the stacks (in-place writes
    land in them) or the layer's own."""
    return [_entry(cache, key, index) for _, key, index in layer_slots(cfg)]


def lm_init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zeroed caches: an attention block's (B, Hkv, slots, hd) "k" and "v"
    (a ring of its window's slots), an 'rg' block's recurrent state; a
    uniform stack's is {"k", "v"} with a leading layer axis."""
    dtype = dtype_of(cfg.compute_dtype)

    def make(kind, stack):
        if kind in RECURRENT:
            return RECURRENT[kind][2](cfg, batch, dtype, device, stack=stack)
        c = init_attn_cache(cfg, batch, max_len, _block_window(cfg, kind),
                            dtype, device, layers=stack or 1)
        return c if stack else {k: v[0] for k, v in c.items()}
    return _init_caches(cfg, make)


def _write_state(c, state, slot=None) -> None:
    """Copy a prefill's recurrent state (each of its tensors) into the
    cache entry ``c`` (all rows, or batch slot ``slot``), in place."""
    for name in state:
        dst = c[name] if slot is None else c[name][slot]
        src = state[name] if slot is None else state[name][0]
        dst.copy_(src)


def block_prefill(cfg, p, x, c, *, positions, mode: str = "reference",
                  mesh=None, data_axes=("data",),
                  qkv_plan: str = "rope_fused", kind: str = "attn"):
    """Full-sequence block that also fills its layer's cache entry ``c``
    (in place)."""
    if kind in RECURRENT:
        o, state = _recurrent(cfg, p, x, kind, PREFILL)
        _write_state(c, state)
        return _recurrent_rest(cfg, p, x, o, mode=mode,
                               mesh=mesh, data_axes=data_axes,
                               qkv_plan=qkv_plan)[0]
    q, k, v = project_qkv_heads(cfg, p["attn"], x, positions, mode=mode,
                                prenorm=norm_params(p, "ln1"),
                                qkv_plan=qkv_plan)
    o = attend(cfg, q, k, v, window=_block_window(cfg, kind), mode=mode)
    prefill_attn_cache(c["k"], c["v"], k, v)
    x = x + cfg.residual_scale * (_merge_heads(o) @ p["attn"]["wo"])
    return _ffn(cfg, p, x, mode=mode, mesh=mesh, data_axes=data_axes,
                qkv_plan=qkv_plan)[0]


def block_decode(cfg, p, x, c, pos, *, mode: str = "reference",
                 mesh=None, data_axes=("data",),
                 qkv_plan: str = "rope_fused", kind: str = "attn"):
    if kind in RECURRENT:
        return _recurrent_rest(cfg, p, x, _recurrent(cfg, p, x, kind, DECODE,
                                                     c), mode=mode,
                               mesh=mesh, data_axes=data_axes,
                               qkv_plan=qkv_plan)[0]
    h = apply_norm(cfg, x, p, "ln1")
    a = decode_attention_layer(cfg, p["attn"], h, c["k"], c["v"], pos,
                               window=_block_window(cfg, kind), mode=mode)
    return _ffn(cfg, p, x + cfg.residual_scale * a, mode=mode,
                mesh=mesh, data_axes=data_axes,
                qkv_plan=qkv_plan)[0]


def lm_prefill(cfg, params, tokens, cache, *, mode: str = "reference",
               mesh=None, data_axes=("data",),
               qkv_plan: str = "rope_fused"):
    """Fills ``cache`` in place. Returns (cache, last-position logits
    (B, V))."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for (kind, p), c in zip(_layers(cfg, params), _layer_caches(cfg, cache)):
        x = block_prefill(cfg, p, x, c, positions=positions, mode=mode,
                          mesh=mesh, data_axes=data_axes,
                          qkv_plan=qkv_plan, kind=kind)
    return cache, _logits(cfg, params, x[:, -1:, :])[:, 0]


def lm_decode_step(cfg, params, token, cache, pos, *,
                   mode: str = "reference",
                   mesh=None, data_axes=("data",),
                   qkv_plan: str = "rope_fused"):
    """token: (B, 1); pos: the position being written, a Python int or a
    one-element int64 tensor on the cache's device (what a captured step
    reads; the same bits). Updates ``cache`` in place. Returns (cache,
    logits (B, V))."""
    x = _embed(cfg, params, token)
    for (kind, p), c in zip(_layers(cfg, params), _layer_caches(cfg, cache)):
        x = block_decode(cfg, p, x, c, pos, mode=mode,
                         mesh=mesh, data_axes=data_axes,
                         qkv_plan=qkv_plan, kind=kind)
    return cache, _logits(cfg, params, x)[:, 0]


# ---------------------------------------------------------------------------
# Paged decode path (shared page pool)
# ---------------------------------------------------------------------------

def lm_init_paged_cache(cfg, batch_slots: int, n_pages: int, page_size: int,
                        device) -> dict:
    """The paged caches in the parameters' layout: an attention block's
    {"k_pages", "v_pages"}, each (P, Hkv, page, hd) (a uniform stack's with
    a leading layer axis: the reference's scan-stacked layout, so the pools
    compare directly), a recurrent block's state per batch slot."""
    dtype = dtype_of(cfg.compute_dtype)

    def make(kind, stack):
        if kind in RECURRENT:
            return RECURRENT[kind][2](cfg, batch_slots, dtype, device,
                                      stack=stack)
        pool = init_paged_attn_cache(cfg, n_pages, page_size, dtype, device)
        if stack is None:
            return pool
        return {k: v[None].repeat(stack, 1, 1, 1, 1) for k, v in pool.items()}
    return _init_caches(cfg, make)


def _attention_only(cfg) -> bool:
    """True when every layer is attention-family. The serving fast paths
    (chunked prefill, prefix reuse, multi-token verify) rely on a KV cache of
    position-addressable pages; recurrent state cannot be re-entered."""
    return all(cfg.layer_kind(i) in ATTENTION_KINDS
               for i in range(cfg.num_layers))


def _int32(x, device):
    """A contiguous int32 tensor on ``device`` (one upload for a host array)."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).contiguous()


def block_prefill_paged(cfg, p, x, c, *, page_rows, slot, positions,
                        mode: str = "reference", mesh=None,
                        data_axes=("data",), qkv_plan: str = "rope_fused",
                        kind: str = "attn"):
    """Single-sequence (B = 1) prefill block: rotated k/v land in the
    sequence's pages, a recurrent block's state in batch slot ``slot`` (in
    place)."""
    if kind in RECURRENT:
        o, state = _recurrent(cfg, p, x, kind, PREFILL)
        _write_state(c, state, slot)
        return _recurrent_rest(cfg, p, x, o, mode=mode,
                               mesh=mesh, data_axes=data_axes,
                               qkv_plan=qkv_plan)[0]
    q, k, v = project_qkv_heads(cfg, p["attn"], x, positions, mode=mode,
                                prenorm=norm_params(p, "ln1"),
                                qkv_plan=qkv_plan)
    o = attend(cfg, q, k, v, window=_block_window(cfg, kind), mode=mode)
    paged_prefill_attn_cache(cfg, c, k, v, page_rows)
    x = x + cfg.residual_scale * (_merge_heads(o) @ p["attn"]["wo"])
    return _ffn(cfg, p, x, mode=mode, mesh=mesh, data_axes=data_axes,
                qkv_plan=qkv_plan)[0]


def lm_prefill_paged(cfg, params, tokens, cache, page_rows, slot: int,
                     true_len: int, *, mode: str = "reference",
                     mesh=None, data_axes=("data",),
                     qkv_plan: str = "rope_fused"):
    """Prefill ONE sequence into the shared paged cache (in place).

    tokens: (1, S); ``page_rows``: (max_pages,) page-table row; ``slot``:
    the sequence's batch slot (recurrent state lands there). S may exceed
    ``true_len`` (a padded bucket) only for attention-only stacks: k/v past
    it stay masked by the length until overwritten, but a recurrent state
    would absorb the pad positions, so an engine serving a recurrent stack
    passes the exact length. Returns (cache, logits (1, V) at position
    ``true_len - 1``)."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for (kind, p), c in zip(_layers(cfg, params), _layer_caches(cfg, cache)):
        x = block_prefill_paged(cfg, p, x, c, page_rows=page_rows, slot=slot,
                                positions=positions, mode=mode,
                                    mesh=mesh, data_axes=data_axes,
                                qkv_plan=qkv_plan, kind=kind)
    return cache, _logits(cfg, params, x[:, true_len - 1:true_len])[:, 0]


def block_prefill_paged_chunk(cfg, p, x, cache, *, page_rows, table, start,
                              length, positions, mode: str = "reference",
                              mesh=None, data_axes=("data",),
                              qkv_plan: str = "rope_fused",
                              kind: str = "attn"):
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
                               length, window=_block_window(cfg, kind),
                               softcap=cfg.attn_logit_softcap, mode=mode)
    x = x + cfg.residual_scale * (_merge_heads(o.to(x.dtype))
                                  @ p["attn"]["wo"])
    return _ffn(cfg, p, x, mode=mode, mesh=mesh, data_axes=data_axes,
                qkv_plan=qkv_plan)[0]


def lm_prefill_paged_chunk(cfg, params, tokens, cache, page_rows, start: int,
                           last_index: int, *, mode: str = "reference",
                           mesh=None, data_axes=("data",),
                           qkv_plan: str = "rope_fused"):
    """Prefill ONE chunk of one sequence into the shared paged cache.

    tokens: (1, C), C a whole number of pages; ``start``: the chunk's first
    absolute position (a page multiple); ``last_index``: the final true
    token within the chunk (its logits seed sampling; meaningful on the
    last chunk only). Prefix-cache admission reuses it with ``start`` = the
    matched prefix length. Attention-family stacks only. Returns (cache,
    logits (1, V))."""
    if not _attention_only(cfg):
        raise ValueError(
            "chunked paged prefill requires an attention-only stack; "
            f"{cfg.name} has recurrent layers; use lm_prefill_paged")
    x = _embed(cfg, params, tokens)
    c = tokens.shape[1]
    positions = start + torch.arange(c, device=x.device)
    table = _int32(page_rows, x.device)[None, :]
    length = _int32([start + c], x.device)
    for (kind, p), lc in zip(_layers(cfg, params), _layer_caches(cfg, cache)):
        x = block_prefill_paged_chunk(
            cfg, p, x, lc, page_rows=page_rows, table=table, start=start,
            length=length, positions=positions, mode=mode,
                mesh=mesh, data_axes=data_axes, qkv_plan=qkv_plan,
            kind=kind)
    return cache, _logits(cfg, params,
                          x[:, last_index:last_index + 1])[:, 0]


def block_decode_paged(cfg, p, x, c, page_table, lengths, *,
                       mode: str = "reference",
                       mesh=None, data_axes=("data",),
                       qkv_plan: str = "rope_fused", kind: str = "attn"):
    if kind in RECURRENT:
        return _recurrent_rest(cfg, p, x, _recurrent(cfg, p, x, kind, DECODE,
                                                     c), mode=mode,
                               mesh=mesh, data_axes=data_axes,
                               qkv_plan=qkv_plan)[0]
    h = apply_norm(cfg, x, p, "ln1")
    a = paged_decode_attention_layer(cfg, p["attn"], h, c, page_table,
                                     lengths, window=_block_window(cfg, kind),
                                     mode=mode)
    return _ffn(cfg, p, x + cfg.residual_scale * a, mode=mode,
                mesh=mesh, data_axes=data_axes,
                qkv_plan=qkv_plan)[0]


def lm_decode_step_paged(cfg, params, token, cache, page_table, lengths, *,
                         mode: str = "reference",
                         mesh=None, data_axes=("data",),
                         qkv_plan: str = "rope_fused"):
    """One decode step for every batch slot over the paged cache (in place).

    token: (B, T). T == 1 is plain decode (each slot's token lands at
    position lengths[b]; logits (B, V)); T > 1 is the speculative verify
    step (token t lands at lengths[b] + t; logits (B, T, V); attention-only
    stacks). ``page_table`` (B, MP) and ``lengths`` (B,): host arrays or
    tensors, moved to the model's device once per call. Inactive slots
    decode against the null page and produce ignorable logits (and advance
    their recurrent state, which an admission's prefill overwrites)."""
    if token.shape[1] > 1 and not _attention_only(cfg):
        raise ValueError(
            "multi-token paged decode (speculative verify) requires an "
            f"attention-only stack; {cfg.name} has recurrent layers")
    x = _embed(cfg, params, token)
    page_table = _int32(page_table, x.device)
    lengths = _int32(lengths, x.device)
    for (kind, p), c in zip(_layers(cfg, params), _layer_caches(cfg, cache)):
        x = block_decode_paged(cfg, p, x, c, page_table, lengths, mode=mode,
                               mesh=mesh, data_axes=data_axes,
                               qkv_plan=qkv_plan, kind=kind)
    logits = _logits(cfg, params, x)
    if token.shape[1] > 1:
        return cache, logits          # (B, T, V): speculative verify
    return cache, logits[:, 0]
