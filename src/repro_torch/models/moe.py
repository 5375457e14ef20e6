"""Mixture-of-experts FFN: top-k routing, on one device or over a mesh.

* ``dense``: every expert runs on every token, and a (T, E) gate that
  holds each token's top-k routing weights combines the experts' outputs
  (the reference's ``moe_dense``).
* ``ep``: expert parallelism over the mesh's 'model' axis. Each rank holds
  E / ep experts; its tokens (a 1/ep slice of the sequence where that
  divides) are routed into per-expert capacity buckets, sent to the
  experts' owners by an all-to-all, run there and sent back
  (:func:`moe_ep`).
* ``tp``: tensor parallelism. Every rank holds every expert's 1/tp slice
  of the FFN hidden dim, runs the buckets of the (replicated) tokens and
  the partial outputs are summed over 'model' in rank order
  (:func:`moe_tp`).

Each rank holds plain local tensors, as the reference's ``shard_map``
bodies see them, and ``torch.distributed`` collectives over the mesh's
groups stand where the reference has ``all_to_all``/``all_gather``/
``psum``/``pmean``, differentiable (``collectives``' autograd Functions),
so both paths train. The bucket slots are the reference's exactly: a
token-major running count per expert (``cumsum`` of the one-hot), tokens
beyond the capacity (:func:`_capacity`) dropped.

'kernel' mode runs each expert as two ``gemm_fused`` launches, the
dual-output up-projection whose store applies the gated activation, then
the down-projection: on the dense path over the normed tokens shared by
every expert (no (E, T, D) broadcast), on ep/tp over each local expert's
bucket (M = the capacity). Unlike the reference, which takes the einsum
where its autotuner's chain model says "unfused", kernel mode always runs
the fused experts (the port has no autotuner). 'reference' runs the plain
products, one expert at a time.

Nothing on the dense path synchronises with the host or takes a shape from
the data (no ``.item()``, ``nonzero`` or boolean indexing), so a decode
step that runs an MoE block captures in a CUDA graph. The ep/tp paths run
collectives; the engines decode a model with a mesh eagerly.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.gemm import Epilogue, gemm_fused
from .common import _EPILOGUE_ACT, ParamDef, act_fn, apply_prenorm

IMPLS = ("auto", "dense", "ep", "tp")


def _gated(cfg) -> bool:
    return cfg.mlp_act in ("swiglu", "geglu")


def moe_defs(cfg, prefix: str, *, stack: int | None = None) -> dict:
    """The router (D, E) and the experts' (E, D, F) up and (E, F, D) down
    projections (w_gate beside w_in for a gated activation), with a leading
    layer axis under ``stack``: the reference's keys and shapes."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    lead = (stack,) if stack else ()
    lx = ("layers",) if stack else ()
    dt = cfg.param_dtype
    if cfg.moe.shard == "expert":      # EP: the expert dim over 'model'
        in_axes = lx + ("expert", "embed", None)
        out_axes = lx + ("expert", None, "embed")
    else:                               # TP: the FFN hidden dim over 'model'
        in_axes = lx + (None, "embed", "ffn")
        out_axes = lx + (None, "ffn", "embed")
    defs = {f"{prefix}/router": ParamDef(lead + (d, e), lx + ("embed", None),
                                         dtype=dt),
            f"{prefix}/w_in": ParamDef(lead + (e, d, f), in_axes, dtype=dt),
            f"{prefix}/w_out": ParamDef(lead + (e, f, d), out_axes, dtype=dt)}
    if _gated(cfg):
        defs[f"{prefix}/w_gate"] = ParamDef(lead + (e, d, f), in_axes,
                                            dtype=dt)
    return defs


def _route(cfg, x_flat, router_w):
    """x_flat: (T, D). Returns (weights (T, K) in x's type, ids (T, K),
    the Switch load-balancing loss). The router product runs in fp32. The
    top k come from a stable descending sort, so exact ties go to the lower
    expert index, as ``jax.lax.top_k`` breaks them."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    k, e = cfg.moe.top_k, cfg.moe.num_experts
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = ranked[:, :k], order[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    first = ids[:, :1] == torch.arange(e, device=ids.device)
    aux = e * torch.sum(first.float().mean(0) * probs.mean(0))
    return weights.to(x_flat.dtype), ids, aux


def _experts(cfg, p) -> list:
    """Each expert's weights, (w_gate, w_in, w_out) or (w_in, w_out), as
    views of the layer's stacked (E, ., .) leaves made by one ``unbind`` per
    leaf: its backward stacks the experts' grads once, where indexing each
    expert would add a zero-filled full-size buffer per expert (as
    ``lm.unstack_layers`` does for the layers)."""
    names = ("w_gate", "w_in", "w_out") if _gated(cfg) else ("w_in", "w_out")
    return list(zip(*(p[n].unbind(0) for n in names)))


def _tokens_of(x, i: int):
    """Expert ``i``'s tokens: x itself where every expert reads the same
    (T, D) tokens, else its bucket x[i] of an (E, C, D) buffer."""
    return x if x.dim() == 2 else x[i]


def _expert_ffn(cfg, p, x):
    """x: (T, D), the same tokens for every expert, or (E, C, D), one
    bucket per expert -> (E, T or C, D), the plain products one expert at a
    time, each expert's weights cast to x's type as they are reached (a
    no-op where the types agree; an fp32 path over bf16 experts upcasts one
    expert at a time, exactly)."""
    act = act_fn(cfg.mlp_act)
    outs = []
    for i, ws in enumerate(_experts(cfg, p)):
        *w_up, w_out = (w.to(x.dtype) for w in ws)
        x_i = _tokens_of(x, i)
        if _gated(cfg):
            w_gate, w_in = w_up
            h = act(x_i @ w_gate) * (x_i @ w_in)
        else:
            h = act(x_i @ w_up[0])
        outs.append(h @ w_out)
    return torch.stack(outs)


def _expert_ffn_fused(cfg, p, x):
    """Kernel mode of :func:`_expert_ffn`: per expert, the up-projection as
    one dual-output ``gemm_fused`` launch whose store is act(x @ w_gate) *
    (x @ w_in) (or one launch of act(x @ w_in) for a plain activation), and
    the down-projection as a second launch with no epilogue, each at M =
    the tokens the expert reads (T, or its bucket's C rows). The weights
    are contiguous views of the layer's stacked leaves (:func:`_experts`)."""
    if cfg.mlp_act not in _EPILOGUE_ACT:
        raise ValueError(cfg.mlp_act)
    gated = _gated(cfg)
    up = Epilogue(activation=_EPILOGUE_ACT[cfg.mlp_act], gate=gated)
    outs = []
    for i, (*w_up, w_out) in enumerate(_experts(cfg, p)):
        x_i = _tokens_of(x, i)
        if gated:
            w_gate, w_in = w_up
            h = gemm_fused(x_i, w_gate, b2=w_in, epilogue=up,
                           out_dtype=x.dtype)
        else:
            h = gemm_fused(x_i, w_up[0], epilogue=up, out_dtype=x.dtype)
        outs.append(gemm_fused(h, w_out, out_dtype=x.dtype))
    return torch.stack(outs)


def moe_dense(cfg, p, x, *, mode: str = "reference", auto: bool = False):
    """Every expert on every token. x: (..., D) (already normed). Returns
    (the gate-weighted sum of the experts' outputs, x's shape; aux)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    weights, ids, aux = _route(cfg, xf, p["router"])
    outs = _run_experts(cfg, p, xf, mode, auto)
    gate = torch.zeros((xf.shape[0], cfg.moe.num_experts), dtype=x.dtype,
                       device=x.device).scatter_add_(1, ids, weights)
    out = torch.einsum("te,etd->td", gate, outs)
    return out.reshape(x.shape), aux


def _run_experts(cfg, p, x, mode: str, auto: bool, shard=None):
    """The experts on their tokens: kernel mode's fused launches, except
    with ``auto`` (the model's ``qkv_plan="auto"``) where
    ``select_fusion("mlp", (T, D, F, gated), residual=False, shard=)`` says
    "unfused" (the reference's ``_expert_ffn_fused`` returning to the
    einsum); then the plain FFN."""
    if mode == "kernel" and _experts_fused(cfg, p, x, auto, shard):
        return _expert_ffn_fused(cfg, p, x)
    return _expert_ffn(cfg, p, x)


def _experts_fused(cfg, p, x, auto: bool, shard) -> bool:
    if not auto:
        return True
    from repro_torch.core import autotune

    t = x.shape[-2]
    shape = (t, x.shape[-1], p["w_in"].shape[-1], int(_gated(cfg)))
    return autotune.select_fusion("mlp", shape, x.dtype, residual=False,
                                  shard=shard)["plan"] == "fused"


def _shard(mesh, model_axis: str, impl: str):
    """The ShardSpec the reference scores an ep or tp expert chain with."""
    from repro_torch.distributed.sharding import ShardSpec

    return ShardSpec.for_axis(
        mesh, model_axis, dim="expert" if impl == "ep" else "ffn",
        collective="all_to_all" if impl == "ep" else "all_reduce")


def _capacity(tokens_per_shard: int, cfg) -> int:
    """A bucket's rows: ceil(T * k * capacity_factor / E), at least 8 and
    rounded up to a multiple of 8, as the reference's."""
    c = math.ceil(tokens_per_shard * cfg.moe.top_k * cfg.moe.capacity_factor
                  / cfg.moe.num_experts)
    return max(8, -(-c // 8) * 8)


def _dispatch(cfg, t, ids, cap: int):
    """The capacity buckets of tokens ``t`` (T, D) routed to ``ids`` (T,
    K): (buf (E, cap, D), idx (T*K,) each choice's row of buf viewed as
    (E*cap, D), keep (T*K,)). A choice's slot is the running count of the
    choices of its expert before it, token-major (the ``cumsum`` of the
    one-hot); choices at slot ``cap`` and beyond are dropped (added as
    zeros), as in the reference."""
    e, d = cfg.moe.num_experts, t.shape[-1]
    k = ids.shape[1]
    flat_ids = ids.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_ids, e).to(torch.int32)
    slot = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=1) - 1
    keep = (slot >= 0) & (slot < cap)
    idx = flat_ids * cap + torch.clamp(slot, 0, cap - 1)
    src = t.repeat_interleave(k, dim=0) * keep[:, None].to(t.dtype)
    buf = torch.zeros((e * cap, d), dtype=t.dtype, device=t.device)
    buf.index_add_(0, idx, src)
    return buf.view(e, cap, d), idx, keep


def _combine(back, idx, keep, weights):
    """Each token's k expert outputs from ``back`` (E, cap, D) weighted and
    summed: (T, D); a dropped choice adds zero."""
    d = back.shape[-1]
    k = weights.shape[1]
    gathered = back.reshape(-1, d)[idx]
    scale = (keep[:, None] * weights.reshape(-1)[:, None]).to(back.dtype)
    return torch.sum((gathered * scale).reshape(-1, k, d), dim=1)


def _normed(cfg, t, prenorm):
    """The block's norm on a rank's tokens (rowwise, so norming a slice is
    slicing the normed stream)."""
    return t if prenorm is None else apply_prenorm(cfg, t, prenorm)


def moe_ep(cfg, p, x, *, mesh, data_axes=("data",), model_axis="model",
           mode: str = "reference", prenorm=None, auto: bool = False):
    """Expert-parallel MoE on one rank. x: this rank's (B_local, S, D)
    tokens; p: the full router and this rank's E / ep experts (the
    'model' coordinate's slice of the expert dim). Returns (out x's shape,
    aux averaged over 'model' and ``data_axes``).

    Where ep divides the sequence (``s % ep == 0 and s >= ep``) each rank
    routes its 1/ep slice of the sequence, the (E, cap, D) buckets go to
    the experts' owners by an all-to-all, come back by a second, and the
    outputs are all-gathered along the sequence. Otherwise (a decode step
    of few tokens) every rank routes the replicated tokens, runs its own
    experts' buckets and the outputs are all-gathered over the experts.
    ``prenorm``: the block's norm, applied to the rank's tokens.

    The collectives are differentiable (``collectives``' autograd
    Functions): where replicated tensors (the stream, the norm's scale,
    the router, the replicated buckets) enter per-rank work they pass
    f, whose backward sums the ranks' grads, so their grads are whole on
    every rank; the aux term is the mean of the ranks' terms only where
    each rank routes its own tokens."""
    from repro_torch.distributed import collectives as col

    e = cfg.moe.num_experts
    group = mesh.get_group(model_axis)
    ep = col.axis_size(mesh, model_axis)
    rank = mesh.get_local_rank(model_axis)
    if e % ep:
        raise ValueError(f"moe_ep: {e} experts do not divide over {ep} ranks")
    e_loc = e // ep
    bl, s, d = x.shape
    seq_split = s % ep == 0 and s >= ep
    router = p["router"]
    if seq_split:
        # each rank's own tokens: the replicated inputs enter through f
        xs = col.copy_to_ranks(x, group).narrow(1, rank * (s // ep), s // ep)
        router = col.copy_to_ranks(router, group)
        if prenorm is not None:
            prenorm = tuple(None if w is None else col.copy_to_ranks(w, group)
                            for w in prenorm)
    else:
        xs = x
    t = _normed(cfg, xs.reshape(-1, d), prenorm)
    weights, ids, aux = _route(cfg, t, router)
    cap = _capacity(t.shape[0], cfg)
    buf, idx, keep = _dispatch(cfg, t, ids, cap)
    if seq_split:
        # (E, cap, D) -> the experts' owners: (ep, E_loc, cap, D) received
        recv = col.all_to_all_grad(buf, group).view(ep, e_loc, cap, d)
        mine = recv.transpose(0, 1).reshape(e_loc, ep * cap, d)
        out = _run_experts(cfg, p, mine, mode, auto,
                           _shard(mesh, model_axis, "ep"))
        sent = out.view(e_loc, ep, cap, d).transpose(0, 1)
        back = col.all_to_all_grad(sent.reshape(e, cap, d), group)
    else:
        mine = col.copy_to_ranks(buf, group).narrow(0, rank * e_loc, e_loc)
        back = col.gather_cat(
            _run_experts(cfg, p, mine, mode, auto,
                         _shard(mesh, model_axis, "ep")),
            0, group, grad="own")
    y = _combine(back.view(e, cap, d), idx, keep, weights)
    if seq_split:
        full = col.gather_cat(y.view(bl, s // ep, d), 1, group, grad="own")
        aux = col.sum_from_ranks(aux, group) / ep
    else:
        full = y.view(bl, s, d)
    return full, col.mean_over(aux, mesh, data_axes)


def moe_tp(cfg, p, x, *, mesh, data_axes=("data",), model_axis="model",
           mode: str = "reference", prenorm=None, auto: bool = False):
    """Tensor-parallel MoE on one rank: every expert's FFN hidden dim is
    split over ``model_axis`` (p: the full router, each expert's F / tp
    slice of w_gate, w_in and w_out), the tokens are replicated over it.
    Every rank routes all its tokens into the (E, cap, D) buckets, runs
    every expert on its F slice (a partial sum of the output) and the
    partials are summed over 'model' (g, in rank order), the wire cost of
    a dense Megatron MLP. The buckets and the routing
    weights enter the split work through f, so their grads are summed.
    Returns (out x's shape, aux averaged over ``data_axes``)."""
    from repro_torch.distributed import collectives as col

    group = mesh.get_group(model_axis)
    bl, s, d = x.shape
    t = _normed(cfg, x.reshape(-1, d), prenorm)
    weights, ids, aux = _route(cfg, t, p["router"])
    cap = _capacity(t.shape[0], cfg)
    buf, idx, keep = _dispatch(cfg, t, ids, cap)
    out = _run_experts(cfg, p, col.copy_to_ranks(buf, group), mode, auto,
                       _shard(mesh, model_axis, "tp"))
    y = _combine(out, idx, keep, col.copy_to_ranks(weights, group))
    y = col.sum_from_ranks(y, group)
    return y.view(bl, s, d), col.mean_over(aux, mesh, data_axes)


def resolve_impl(cfg, mesh, model_axis: str = "model") -> str:
    """``cfg.moe.impl``, with "auto" resolved as the reference resolves it:
    "dense" without a mesh or with a 'model' extent of 1, "ep" where the
    experts are sharded by expert and divide the extent, else "tp"."""
    impl = cfg.moe.impl
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; have {IMPLS}")
    if impl != "auto":
        return impl
    if mesh is None:
        return "dense"
    from repro_torch.distributed import mesh_shape

    size = mesh_shape(mesh).get(model_axis, 1)
    if size == 1:
        return "dense"
    if cfg.moe.shard == "expert" and cfg.moe.num_experts % size == 0:
        return "ep"
    return "tp"


def moe_forward(cfg, p, x, *, mesh=None, data_axes=("data",),
                model_axis: str = "model", mode: str = "reference",
                prenorm=None, auto: bool = False):
    """The block's MoE FFN on ``x`` -> (out, aux), by
    :func:`resolve_impl`. With ``prenorm`` (the block's norm params) ``x``
    is the pre-norm stream: the dense path norms it standalone, as the
    reference's does, and its output feeds both the router and the
    experts; ep and tp norm each rank's tokens. ``auto`` (the model's
    ``qkv_plan="auto"``): the experts' plan follows ``select_fusion``."""
    impl = resolve_impl(cfg, mesh, model_axis)
    if impl in ("ep", "tp"):
        if mesh is None:
            raise NotImplementedError(
                f"{cfg.name}: moe impl {impl!r} needs a device mesh "
                "(build_model(cfg, mesh=...)); without one the MoE runs "
                "'dense'")
        fn = moe_ep if impl == "ep" else moe_tp
        return fn(cfg, p, x, mesh=mesh, data_axes=data_axes,
                  model_axis=model_axis, mode=mode, prenorm=prenorm,
                  auto=auto)
    if prenorm is not None:
        x = apply_prenorm(cfg, x, prenorm)
    return moe_dense(cfg, p, x, mode=mode, auto=auto)


def local_experts(cfg, p, mesh, model_axis: str = "model") -> dict:
    """One MoE layer's params ``p`` as a rank holds them under
    :func:`resolve_impl`: under "ep" the rank's E / ep experts (the expert
    dim, third from the end), under "tp" each expert's F / tp slice (w_in
    and w_gate's last dim, w_out's second to last); the router whole.
    Views; ``p`` itself under "dense"."""
    from repro_torch.distributed import collectives as col

    impl = resolve_impl(cfg, mesh, model_axis)
    if impl == "dense":
        return p
    n, r = col.axis_size(mesh, model_axis), mesh.get_local_rank(model_axis)

    def cut(t, dim):
        size = t.shape[dim] // n
        return t.narrow(dim, r * size, size).contiguous()
    out = dict(p)
    for name in ("w_gate", "w_in", "w_out"):
        if name in p:
            dim = -3 if impl == "ep" else (-2 if name == "w_out" else -1)
            out[name] = cut(p[name], dim)
    return out
