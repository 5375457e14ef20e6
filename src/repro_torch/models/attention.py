"""GQA/MHA attention layer: projections, RoPE, flash attention, KV caches.

'kernel' mode runs the reference's QKV plan ladder, with the rung given
explicitly (``qkv_plan``, the decision a measured table pins in the
reference):

1. ``rope_fused``: the block's pre-norm folds into the packed q|k GEMM's
   prologue and RoPE rides its store; v projects through a second fused GEMM
   with the same prologue (the reference's byte model picks this rung at
   every llama shape, so it is the default);
2. ``norm_fused``: the same two GEMMs without the rope store, then the
   standalone RoPE op (the kernel at S >= 128, as in the reference);
3. ``unfused``: the standalone norm, plain projections and the standalone
   RoPE op;

or ``auto``: the rung the reference's two decisions give, in its order
(:func:`auto_qkv`, ``core.autotune.select_fusion``): rung 1 where the
norm-folded 'qkv_rope' chain wins, else rung 1 behind the standalone norm
where the plain 'qkv_rope' chain's fused plan wins, else rung 2 where the
norm-folded rope-free 'qkv' chain wins, else rung 3.

A RoPE style other than 'half', a head_dim whose heads the store's tiles
cannot hold whole (``rope_store_fits``), or a rope-free block
(``use_rope=False``: the encoder's and the enc-dec's) cannot ride the
store, so rung 1 sends it down rung 2, as the reference does. Prefill
attention is the flash kernel, causal or not; cross-attention
(``kv_input``) keeps the standalone norm and plain projections, as in the
reference.
Decode projects q/k/v with plain products and rotates them with the plain
RoPE (as the reference does), appends to the contiguous (ring) cache or to
the paged pool in place and runs the split-KV decode kernel (contiguous or
paged); a cross-attention step reads a static cache whose every slot is
valid. 'reference' mode is the plain unfused path of the reference
package.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels.attention import (attention, attention_decode,
                                           attention_decode_paged,
                                           attention_ref, decode_ref)
from repro_torch.kernels.gemm import Epilogue, gemm_fused, rope_store_fits
from repro_torch.kernels.rope import rope, rope_ref, rope_tables
from repro_torch.serve.kv_cache import (append_paged_kv, init_page_pool,
                                       write_prefill_pages)
from .common import (ParamDef, apply_prenorm, norm_prologue_kw,
                     resolve_norm_prologue)

QKV_PLANS = ("rope_fused", "norm_fused", "unfused", "auto")
# the reference's rope kernel takes whole sequence blocks; shorter
# sequences (and decode) rotate with the plain version
ROPE_KERNEL_MIN_SEQ = 128


def attn_defs(cfg, prefix: str, *, stack: int | None = None,
              cross: bool = False) -> dict:
    """q and k projections are one pre-packed ``wqk`` (d, (H+Hkv)*hd); a
    cross-attention block (``cross``) has no q|k/v bias."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    dt = cfg.param_dtype
    kv_ax = "kv_heads" if cfg.kv_shard else None
    defs = {
        f"{prefix}/wqk": ParamDef(lead + (d, (h + hkv) * hd),
                                  lx + ("embed", "heads"), dtype=dt),
        f"{prefix}/wv": ParamDef(lead + (d, hkv * hd), lx + ("embed", kv_ax),
                                 dtype=dt),
        f"{prefix}/wo": ParamDef(lead + (h * hd, d), lx + ("heads", "embed"),
                                 dtype=dt),
    }
    if cfg.qkv_bias and not cross:
        defs[f"{prefix}/bqk"] = ParamDef(lead + ((h + hkv) * hd,),
                                         lx + ("heads",), init="zeros",
                                         dtype=dt)
        defs[f"{prefix}/bv"] = ParamDef(lead + (hkv * hd,), lx + (kv_ax,),
                                        init="zeros", dtype=dt)
    return defs


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _apply_rope(cfg, q, k, positions, mode: str):
    """Standalone RoPE on (B, H, S, hd) q/k at absolute ``positions`` (S,):
    the RoPE op (kernel) in 'kernel' mode for the 'half' style at S >= 128,
    else the plain rotation; 'partial' rotates the first half of each head,
    'none' leaves q/k as they are. A rotation counts as the ``obs``
    counter "model.standalone_rope", kernel or plain, as in the
    reference."""
    if cfg.rope_style == "none":
        return q, k
    obs.incr("model.standalone_rope")
    hd = q.shape[-1]
    rot = hd // 2 if cfg.rope_style == "partial" else hd
    sin, cos = rope_tables(positions, rot, cfg.rope_theta)
    use_op = (mode == "kernel" and cfg.rope_style == "half"
              and q.shape[2] >= ROPE_KERNEL_MIN_SEQ)

    def rot_fn(x):
        xr = x[..., :rot]
        out = rope(xr, sin, cos) if use_op else rope_ref(xr, sin, cos)
        if rot == hd:
            return out
        return torch.cat([out, x[..., rot:]], dim=-1)

    return rot_fn(q), rot_fn(k)


def _head_counts(cfg, heads):
    """(q heads, kv heads): ``heads`` (a tensor-parallel rank's) or the
    config's."""
    return heads if heads is not None else (cfg.num_heads, cfg.num_kv_heads)


def project_qkv(cfg, p, x, kv_input=None, heads=None):
    """Plain projections over the packed ``wqk``: q/k are column slices.
    With ``kv_input`` (cross-attention) q projects ``x`` and k/v project
    ``kv_input``. ``heads``: the (q, kv) head counts the leaves hold (a
    tensor-parallel rank's), by default the config's."""
    h, hkv = _head_counts(cfg, heads)
    nq = h * cfg.head_dim
    if kv_input is None:
        qk = x @ p["wqk"]
        q, k = qk[..., :nq], qk[..., nq:]
        v = x @ p["wv"]
    else:
        q = x @ p["wqk"][..., :nq]
        k = kv_input @ p["wqk"][..., nq:]
        v = kv_input @ p["wv"]
    if "bqk" in p:
        q = q + p["bqk"][..., :nq]
        k = k + p["bqk"][..., nq:]
        v = v + p["bv"]
    return (_split_heads(q, h, cfg.head_dim),
            _split_heads(k, hkv, cfg.head_dim),
            _split_heads(v, hkv, cfg.head_dim))


def _heads_of_gemms(cfg, qk, v, b, s, heads=None):
    """(B, H|Hkv, S, hd) views of the packed q|k and the v GEMM outputs."""
    (h, hkv), hd = _head_counts(cfg, heads), cfg.head_dim
    q = qk[:, : h * hd].reshape(b, s, h * hd)
    k = qk[:, h * hd:].reshape(b, s, hkv * hd)
    return (_split_heads(q, h, hd), _split_heads(k, hkv, hd),
            _split_heads(v.reshape(b, s, hkv * hd), hkv, hd))


def fused_project_qkv_rope(cfg, p, x, positions, prenorm=None,
                           use_rope: bool = True, heads=None):
    """Rung 1: q|k through one GEMM whose prologue is the block's pre-norm
    and whose store rotates q and k (RoPE 'half'); v through a second GEMM
    with the same prologue. Returns (B, H|Hkv, S, hd) views of the GEMM
    outputs. Another RoPE style, a head_dim the store cannot rotate, or a
    rope-free block goes down rung 2."""
    if (not use_rope or cfg.rope_style != "half"
            or not rope_store_fits(cfg.head_dim)):
        return project_qkv_heads(cfg, p, x, positions, mode="kernel",
                                 prenorm=prenorm, qkv_plan="norm_fused",
                                 use_rope=use_rope, heads=heads)
    b, s, d = x.shape
    hd = cfg.head_dim
    has_bias = "bqk" in p
    kw = norm_prologue_kw(cfg, prenorm) if prenorm is not None else {}
    x2 = x.reshape(b * s, d)
    sin, cos = rope_tables(positions, hd, cfg.rope_theta)
    # one table row per flattened (batch, seq) token row of the GEMM
    qk = gemm_fused(x2, p["wqk"], epilogue=Epilogue(bias=has_bias, rope=True,
                                                    head_dim=hd),
                    bias=p.get("bqk"), sin=sin.repeat(b, 1),
                    cos=cos.repeat(b, 1), out_dtype=x.dtype, **kw)
    v = gemm_fused(x2, p["wv"], epilogue=Epilogue(bias=has_bias),
                   bias=p.get("bv"), out_dtype=x.dtype, **kw)
    return _heads_of_gemms(cfg, qk, v, b, s, heads)


def fused_project_qkv(cfg, p, x, prenorm, heads=None):
    """Rung 2's projections: the packed q|k GEMM and the v GEMM, each with
    the block's pre-norm in its prologue and the bias in its store, no
    rope. Returns unrotated (B, H|Hkv, S, hd) views of the GEMM outputs."""
    b, s, d = x.shape
    has_bias = "bqk" in p
    kw = norm_prologue_kw(cfg, prenorm)
    x2 = x.reshape(b * s, d)
    ep = Epilogue(bias=has_bias)
    qk = gemm_fused(x2, p["wqk"], epilogue=ep, bias=p.get("bqk"),
                    out_dtype=x.dtype, **kw)
    v = gemm_fused(x2, p["wv"], epilogue=ep, bias=p.get("bv"),
                   out_dtype=x.dtype, **kw)
    return _heads_of_gemms(cfg, qk, v, b, s, heads)


def auto_qkv(cfg, tokens: int, dtype, *, prenorm, use_rope: bool = True,
             heads=None) -> tuple:
    """(rung, whether the norm rides in the GEMMs' prologue) of
    ``qkv_plan="auto"`` for ``tokens`` rows: the reference's decisions in
    its order (its ``fused_project_qkv_rope``, then ``fused_project_qkv``).
    A rope the store cannot hold (``rope_store_fits``) skips rung 1, as the
    fixed rungs do."""
    from repro_torch.core import autotune

    h, hkv = _head_counts(cfg, heads)
    shape = (tokens, cfg.d_model, h, hkv, cfg.head_dim)
    if use_rope and cfg.rope_style == "half" and rope_store_fits(cfg.head_dim):
        if resolve_norm_prologue(cfg, prenorm, kind="qkv_rope",
                                 plan_shape=shape, dtype=dtype):
            return "rope_fused", True
        if autotune.select_fusion("qkv_rope", shape,
                                  dtype)["plan"] == "fused":
            return "rope_fused", False
    if resolve_norm_prologue(cfg, prenorm, kind="qkv", plan_shape=shape,
                             dtype=dtype):
        return "norm_fused", True
    return "unfused", False


def _resolve_auto(cfg, x, prenorm, qkv_plan, mode, use_rope, heads=None):
    """(x, prenorm, rung): ``qkv_plan`` as it is, or "auto" resolved in
    kernel mode, the norm applied here where the rung takes it
    standalone."""
    if mode != "kernel" or qkv_plan != "auto":
        return x, prenorm, qkv_plan
    rung, folded = auto_qkv(cfg, x.shape[0] * x.shape[1], x.dtype,
                            prenorm=prenorm, use_rope=use_rope, heads=heads)
    if prenorm is not None and not folded:
        x, prenorm = apply_prenorm(cfg, x, prenorm), None
    return x, prenorm, rung


def project_qkv_heads(cfg, p, x, positions=None, *, mode: str, prenorm=None,
                      qkv_plan: str = "rope_fused", use_rope: bool = True,
                      heads=None):
    """(q, k, v) heads from the pre-norm stream ``x`` (B, S, D), rotated
    unless ``use_rope`` is False, through rung ``qkv_plan`` of the ladder in
    'kernel' mode. Rung 2 folds the norm into its GEMMs only when there is
    one (``prenorm``), as in the reference; without it the rung is rung
    3."""
    if use_rope and positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, prenorm, qkv_plan = _resolve_auto(cfg, x, prenorm, qkv_plan, mode,
                                         use_rope, heads)
    if mode == "kernel" and qkv_plan == "rope_fused":
        return fused_project_qkv_rope(cfg, p, x, positions, prenorm=prenorm,
                                      use_rope=use_rope, heads=heads)
    if mode == "kernel" and qkv_plan == "norm_fused" and prenorm is not None:
        q, k, v = fused_project_qkv(cfg, p, x, prenorm, heads)
    else:
        if prenorm is not None:
            x = apply_prenorm(cfg, x, prenorm)
        q, k, v = project_qkv(cfg, p, x, heads=heads)
    if use_rope:
        q, k = _apply_rope(cfg, q, k, positions, mode)
    return q, k, v


def attend(cfg, q, k, v, *, window, mode: str, causal: bool = True):
    """Full-sequence attention, causal or not (the encoder, cross
    attention): the flash kernel or the oracle."""
    softcap = cfg.attn_logit_softcap
    if mode == "kernel":
        return attention(q, k, v, causal=causal, window=window,
                         softcap=softcap)
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap)


def _prologue_in_gemms(mode: str, qkv_plan: str, prenorm) -> bool:
    """Whether the QKV ladder folds the block's norm into its GEMMs."""
    return (mode == "kernel" and prenorm is not None
            and qkv_plan in ("rope_fused", "norm_fused"))


def split_attention_layer(cfg, p, x, *, tp, window=None, positions=None,
                          mode: str, prenorm, qkv_plan: str = "rope_fused",
                          causal: bool = True, use_rope: bool = True,
                          kv_input=None):
    """``attention_layer`` on a tensor-parallel rank (``tp``, a
    ``distributed.tensor_parallel.TensorParallel``): the rank's heads
    through the same QKV ladder and flash kernel, its rows of ``wo``, the
    ranks' partial outputs summed (g). The replicated stream enters through
    f; where the norm rides in the GEMMs' prologue its scale and bias do
    too (their grads are partials there), else the norm runs on the
    replicated stream first. Cross-attention (``kv_input``, the replicated
    encoder output, which enters through f as well) takes the standalone
    norm and the plain projections, as on one device. Where the heads do
    not split over the extent the layer runs whole on every rank."""
    p = tp.attn_params(p, "attn" if kv_input is None else "xattn")
    heads = tp.local_heads
    if kv_input is None and heads is not None:
        x, prenorm, qkv_plan = _resolve_auto(cfg, x, prenorm, qkv_plan, mode,
                                             use_rope, heads)
    if heads is None:
        return attention_layer(cfg, p, x, causal=causal, window=window,
                               kv_input=kv_input, positions=positions,
                               mode=mode, prenorm=prenorm, qkv_plan=qkv_plan,
                               use_rope=use_rope)
    if kv_input is None and _prologue_in_gemms(mode, qkv_plan, prenorm):
        prenorm = tuple(None if t is None else tp.f(t) for t in prenorm)
    elif prenorm is not None:
        x, prenorm = apply_prenorm(cfg, x, prenorm), None
    if kv_input is None:
        q, k, v = project_qkv_heads(cfg, p, tp.f(x), positions, mode=mode,
                                    prenorm=prenorm, qkv_plan=qkv_plan,
                                    use_rope=use_rope, heads=heads)
    else:
        q, k, v = project_qkv(cfg, p, tp.f(x), tp.f(kv_input), heads=heads)
    out = attend(cfg, q, k, v, window=window, mode=mode, causal=causal)
    return tp.g(_merge_heads(out) @ p["wo"])


def attention_layer(cfg, p, x, *, causal: bool = True,
                    window: int | None = None, kv_input=None,
                    positions=None, mode: str = "reference", prenorm=None,
                    qkv_plan: str = "rope_fused", use_rope: bool = True):
    """Full-sequence attention (train/prefill). x: (B, S, D). Self-attention
    goes through the QKV ladder; cross-attention (``kv_input`` (B, S_kv,
    D)) takes the standalone norm and the plain projections, as in the
    reference."""
    if kv_input is None:
        q, k, v = project_qkv_heads(cfg, p, x, positions, mode=mode,
                                    prenorm=prenorm, qkv_plan=qkv_plan,
                                    use_rope=use_rope)
    else:
        if prenorm is not None:
            x = apply_prenorm(cfg, x, prenorm)
        q, k, v = project_qkv(cfg, p, x, kv_input)
    out = attend(cfg, q, k, v, window=window, mode=mode, causal=causal)
    return _merge_heads(out) @ p["wo"]


# ---------------------------------------------------------------------------
# KV cache (decode path)
# ---------------------------------------------------------------------------

def cache_len(max_len: int, window: int | None) -> int:
    return min(max_len, window) if window else max_len


def init_attn_cache(cfg, batch: int, max_len: int, window: int | None,
                    dtype, device, *, layers: int) -> dict:
    """A stacked (layers, B, Hkv, slots, hd) cache, zeroed."""
    shape = (layers, batch, cfg.num_kv_heads, cache_len(max_len, window),
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_attn_cache(k_cache, v_cache, k, v) -> None:
    """Write full-prefill k/v (B, Hkv, S, hd) into one layer's (possibly
    ring) cache, in place: slot = pos % slots keeps the last ``slots``
    positions."""
    slots, s = k_cache.shape[2], k.shape[2]
    if s <= slots:
        k_cache[:, :, :s] = k
        v_cache[:, :, :s] = v
        return
    idx = torch.arange(s - slots, s, device=k.device) % slots
    k_cache[:, :, idx] = k[:, :, -slots:]
    v_cache[:, :, idx] = v[:, :, -slots:]


def decode_attention_layer(cfg, p, x, k_cache, v_cache, pos, *,
                           window: int | None = None, cross: bool = False,
                           update_cache: bool = True, use_rope: bool = True,
                           mode: str = "reference"):
    """One-token decode. x: (B, 1, D) (already normed); pos: the current
    position, a Python int or a one-element int64 tensor on x's device (a
    CUDA graph's static input: then the slot and the lengths are derived on
    the device). Appends this token's k/v to the layer's cache in place
    (slot pos % slots; not with ``update_cache=False``) and attends over
    it. With ``cross`` q projects x through ``wqk``'s q columns and
    attends over the static cross-attention cache, every one of its slots
    valid; the cache is read only. Returns (B, 1, D)."""
    b = x.shape[0]
    if cross:
        nq = cfg.num_heads * cfg.head_dim
        q = x @ p["wqk"][..., :nq]
        if "bqk" in p:
            q = q + p["bqk"][..., :nq]
        q = _split_heads(q, cfg.num_heads, cfg.head_dim)
        lengths = torch.full((b,), k_cache.shape[2], dtype=torch.int32,
                             device=x.device)
        window = None
    else:
        q, k_new, v_new = project_qkv(cfg, p, x)
        positions = pos.reshape(1) if torch.is_tensor(pos) else None
        if use_rope:
            if positions is None:
                positions = torch.full((1,), pos, dtype=torch.int64,
                                       device=x.device)
            # decode rotates its one token with the plain RoPE, as the
            # reference
            q, k_new = _apply_rope(cfg, q, k_new, positions, "reference")
        if torch.is_tensor(pos):
            if update_cache:
                slot = torch.remainder(positions, k_cache.shape[2])
                k_cache.index_copy_(2, slot, k_new.to(k_cache.dtype))
                v_cache.index_copy_(2, slot, v_new.to(v_cache.dtype))
            lengths = (positions + 1).to(torch.int32).expand(b).contiguous()
        else:
            if update_cache:
                slot = pos % k_cache.shape[2]
                k_cache[:, :, slot] = k_new[:, :, 0]
                v_cache[:, :, slot] = v_new[:, :, 0]
            lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                                 device=x.device)
    softcap = cfg.attn_logit_softcap
    if mode == "kernel":
        out = attention_decode(q, k_cache, v_cache, lengths, window=window,
                               softcap=softcap)
    else:
        hkv = cfg.num_kv_heads
        qg = q.reshape(b, hkv, cfg.num_heads // hkv, cfg.head_dim)
        out = decode_ref(qg, k_cache, v_cache, lengths, window=window,
                         softcap=softcap).reshape(q.shape)
    return _merge_heads(out.to(x.dtype)) @ p["wo"]


# ---------------------------------------------------------------------------
# Paged KV cache (decode over a shared page pool)
# ---------------------------------------------------------------------------

def init_paged_attn_cache(cfg, n_pages: int, page_size: int, dtype,
                          device) -> dict:
    return init_page_pool(n_pages, cfg.num_kv_heads, page_size, cfg.head_dim,
                          dtype, device)


def paged_prefill_attn_cache(cfg, cache: dict, k, v, page_rows,
                             start_page: int = 0) -> dict:
    """Write one sequence's prefill k/v (1, Hkv, S, hd) into its pages, in
    place. ``start_page`` offsets the write within the page-table row:
    chunk c of a chunked prefill passes its first page index."""
    write_prefill_pages(cache["k_pages"], cache["v_pages"], k, v, page_rows,
                        start_page=start_page)
    return cache


def _apply_rope_positions(cfg, q, k, positions):
    """RoPE with per-sequence positions. q/k: (B, H, T, hd); positions: (B,)
    for T == 1, or (B, T) when each token carries its own position (chunked
    prefill, speculative verify)."""
    if cfg.rope_style == "none":
        return q, k
    hd = q.shape[-1]
    rot = hd // 2 if cfg.rope_style == "partial" else hd
    if positions.dim() == 1:
        sin, cos = rope_tables(positions, rot, cfg.rope_theta)
        sin, cos = sin[:, None, None, :], cos[:, None, None, :]
    else:
        b, t = positions.shape
        sin, cos = rope_tables(positions.reshape(-1), rot, cfg.rope_theta)
        sin, cos = sin.reshape(b, 1, t, rot), cos.reshape(b, 1, t, rot)

    def rot_fn(x):
        out = rope_ref(x[..., :rot], sin, cos)
        if rot == hd:
            return out
        return torch.cat([out, x[..., rot:]], dim=-1)

    return rot_fn(q), rot_fn(k)


def paged_decode_attention_layer(cfg, p, x, cache: dict, page_table, lengths,
                                 *, window: int | None = None,
                                 use_rope: bool = True,
                                 mode: str = "reference"):
    """Decode (1 or T tokens) over the paged cache. x: (B, T, D) (already
    normed); page_table (B, MP) and lengths (B,) are int32 tensors on x's
    device; token t lands at position lengths[b] + t (T > 1 is the verify
    step). Appends to the pools in place; inactive slots (empty table rows)
    write into the null page and read back zeros. Returns (B, T, D)."""
    t = x.shape[1]
    q, k_new, v_new = project_qkv(cfg, p, x)
    if use_rope:
        positions = lengths.long() if t == 1 else (
            lengths.long()[:, None] + torch.arange(t, device=x.device))
        q, k_new = _apply_rope_positions(cfg, q, k_new, positions)
    append_paged_kv(cache["k_pages"], cache["v_pages"], k_new, v_new,
                    page_table, lengths)
    out = attention_decode_paged(q, cache["k_pages"], cache["v_pages"],
                                 page_table, lengths + t, window=window,
                                 softcap=cfg.attn_logit_softcap, mode=mode)
    return _merge_heads(out.to(x.dtype)) @ p["wo"]
