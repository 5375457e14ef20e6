"""Mixture-of-experts FFN: top-k routing over every expert on one device.

The port of the reference's single-device half (``moe_dense``): every
expert runs on every token, and a (T, E) gate that holds each token's
top-k routing weights combines the experts' outputs. The reference's
expert-parallel and tensor-parallel paths (``impl="ep"``/``"tp"``) need a
mesh, which the port does not have yet: they raise.

'kernel' mode runs each expert as two ``gemm_fused`` launches, the
dual-output up-projection whose store applies the gated activation, then
the down-projection; the (T, F) intermediate of an expert is the only one
that exists at a time, and the normed tokens are shared by every expert
(no (E, T, D) broadcast). Unlike the reference, which takes the einsum
where its autotuner's chain model says "unfused", kernel mode always runs
the fused experts (the port has no autotuner). 'reference' runs the plain
products, one expert at a time.

Nothing here synchronises with the host or takes a shape from the data (no
``.item()``, ``nonzero`` or boolean indexing), so a decode step that runs
an MoE block captures in a CUDA graph.
"""
from __future__ import annotations

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
    dt = cfg.param_dtype
    defs = {f"{prefix}/router": ParamDef(lead + (d, e), dtype=dt),
            f"{prefix}/w_in": ParamDef(lead + (e, d, f), dtype=dt),
            f"{prefix}/w_out": ParamDef(lead + (e, f, d), dtype=dt)}
    if _gated(cfg):
        defs[f"{prefix}/w_gate"] = ParamDef(lead + (e, d, f), dtype=dt)
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


def _expert_ffn(cfg, p, x):
    """x: (T, D), the same tokens for every expert -> (E, T, D), the plain
    products one expert at a time, each expert's weights cast to x's type
    as they are reached (a no-op where the types agree; an fp32 path over
    bf16 experts upcasts one expert at a time, exactly)."""
    act = act_fn(cfg.mlp_act)
    outs = []
    for ws in _experts(cfg, p):
        *w_up, w_out = (w.to(x.dtype) for w in ws)
        if _gated(cfg):
            w_gate, w_in = w_up
            h = act(x @ w_gate) * (x @ w_in)
        else:
            h = act(x @ w_up[0])
        outs.append(h @ w_out)
    return torch.stack(outs)


def _expert_ffn_fused(cfg, p, x):
    """Kernel mode of :func:`_expert_ffn`: per expert, the up-projection as
    one dual-output ``gemm_fused`` launch whose store is act(x @ w_gate) *
    (x @ w_in) (or one launch of act(x @ w_in) for a plain activation), and
    the down-projection as a second launch with no epilogue. The weights
    are contiguous views of the layer's stacked leaves (:func:`_experts`)."""
    if cfg.mlp_act not in _EPILOGUE_ACT:
        raise ValueError(cfg.mlp_act)
    gated = _gated(cfg)
    up = Epilogue(activation=_EPILOGUE_ACT[cfg.mlp_act], gate=gated)
    outs = []
    for *w_up, w_out in _experts(cfg, p):
        if gated:
            w_gate, w_in = w_up
            h = gemm_fused(x, w_gate, b2=w_in, epilogue=up,
                           out_dtype=x.dtype)
        else:
            h = gemm_fused(x, w_up[0], epilogue=up, out_dtype=x.dtype)
        outs.append(gemm_fused(h, w_out, out_dtype=x.dtype))
    return torch.stack(outs)


def moe_dense(cfg, p, x, *, mode: str = "reference"):
    """Every expert on every token. x: (..., D) (already normed). Returns
    (the gate-weighted sum of the experts' outputs, x's shape; aux)."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    weights, ids, aux = _route(cfg, xf, p["router"])
    if mode == "kernel":
        outs = _expert_ffn_fused(cfg, p, xf)
    else:
        outs = _expert_ffn(cfg, p, xf)
    gate = torch.zeros((xf.shape[0], cfg.moe.num_experts), dtype=x.dtype,
                       device=x.device).scatter_add_(1, ids, weights)
    out = torch.einsum("te,etd->td", gate, outs)
    return out.reshape(x.shape), aux


def moe_forward(cfg, p, x, *, mode: str = "reference", prenorm=None):
    """The block's MoE FFN on ``x`` -> (out, aux). With ``prenorm`` (the
    block's norm params) ``x`` is the pre-norm stream: the norm runs
    standalone, as the reference's dense path does, and its output feeds
    both the router and the experts. One device: ``impl="auto"`` is
    ``"dense"``."""
    impl = cfg.moe.impl
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r}; have {IMPLS}")
    if impl in ("ep", "tp"):
        raise NotImplementedError(
            f"{cfg.name}: moe impl {impl!r} needs a device mesh; the port "
            "runs the dense single-device MoE (the expert- and tensor-"
            "parallel paths come with the distributed item of ROADMAP "
            "Queue A)")
    if prenorm is not None:
        x = apply_prenorm(cfg, x, prenorm)
    return moe_dense(cfg, p, x, mode=mode)
