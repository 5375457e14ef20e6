"""Plain torch versions of the fused GEMM and its prologue/epilogue chains,
and the hand-written chain-transpose oracle of its backward."""
from __future__ import annotations

import torch

from .epilogue import EPILOGUE_NONE, Epilogue
from .prologue import PROLOGUE_NONE, Prologue


def gemm_fused_ref(a, b, *, epilogue: Epilogue = EPILOGUE_NONE,
                   prologue: Prologue = PROLOGUE_NONE, b2=None,
                   bias=None, residual=None, scale=None, sin=None, cos=None,
                   gamma=None, beta=None, mean=None, rstd=None,
                   out_dtype=torch.bfloat16):
    """C = epilogue(prologue(A) @ B [, A @ B2]) unfused, on full arrays.

    The prologue normalises A in fp32 and rounds it back to A's type before
    the product (the kernel's rounding point); the products accumulate in
    fp32; the epilogue runs in fp32 and the result is cast to ``out_dtype``.
    Operand shapes: gamma/beta (K,); mean/rstd (M,) or (M, 1); bias (N,);
    residual (M, N); scale scalar, (M, 1) or (1, N) per ``scale_kind``;
    sin/cos (M, head_dim) duplicated-halves tables.
    """
    f32 = torch.float32
    if not prologue.is_identity:
        pkw = _prologue_kwargs(prologue, gamma, beta, mean, rstd)
        a = prologue.apply(a.to(f32), **pkw).to(a.dtype)
    acc = a.to(f32) @ b.to(f32)
    acc2 = a.to(f32) @ b2.to(f32) if epilogue.gate else None
    kw = {}
    if epilogue.bias:
        kw["bias"] = bias.to(f32).reshape(1, -1)
    if epilogue.residual:
        kw["residual"] = residual.to(f32)
    if epilogue.scale:
        kw["scale"] = _scale_f32(epilogue, scale, acc.device)
    if epilogue.rope:
        kw["sin"] = sin.to(f32)
        kw["cos"] = cos.to(f32)
    return epilogue.apply(acc, acc2, **kw).to(out_dtype)


def rms_rows_ref(a, gamma, eps: float) -> tuple:
    """Plain version of the forward kernel's rmsnorm row pass
    (``gemm_fused_rows_kernel``): (An in A's type, rstd (M,) fp32), with
    rstd = 1 / sqrt(mean(x^2) + eps) and An = (x rstd) gamma in fp32,
    rounded to A's type: the reference's prologue and rounding point."""
    x = a.to(torch.float32)
    rstd = torch.rsqrt(torch.mean(x * x, dim=-1) + eps)
    an = (x * rstd[:, None] * gamma.to(torch.float32)).to(a.dtype)
    return an, rstd


def ln_rows_ref(a, gamma, beta, eps: float) -> tuple:
    """Plain version of the forward kernel's layernorm row pass: (An in A's
    type, mean (M,) fp32, rstd (M,) fp32), with the mean, the variance of
    the centred values (not E[x^2] - mean^2), rstd = 1 / sqrt(var + eps)
    and An = ((x - mean) rstd) gamma [+ beta] in fp32, rounded to A's
    type: the reference's layernorm prologue and rounding point."""
    x = a.to(torch.float32)
    mean = torch.mean(x, dim=-1)
    c = x - mean[:, None]
    rstd = torch.rsqrt(torch.mean(c * c, dim=-1) + eps)
    an = c * rstd[:, None] * gamma.to(torch.float32)
    if beta is not None:
        an = an + beta.to(torch.float32)
    return an.to(a.dtype), mean, rstd


def norm_rows_ref(a, prologue: Prologue, gamma, beta=None):
    """An of the kernel's row pass for ``prologue`` (rmsnorm or layernorm
    with in-launch statistics), in A's type."""
    if prologue.norm == "layernorm":
        return ln_rows_ref(a, gamma, beta, prologue.eps)[0]
    return rms_rows_ref(a, gamma, prologue.eps)[0]


def _prologue_kwargs(prologue, gamma, beta, mean, rstd) -> dict:
    """The prologue's operands in fp32, shaped to broadcast over rows."""
    f32 = torch.float32
    pkw = {"gamma": gamma.to(f32).reshape(1, -1)}
    if prologue.beta:
        pkw["beta"] = beta.to(f32).reshape(1, -1)
    if prologue.precomputed_stats:
        if prologue.norm == "layernorm":
            pkw["mean"] = mean.to(f32).reshape(-1, 1)
        pkw["rstd"] = rstd.to(f32).reshape(-1, 1)
    return pkw


def _scale_f32(epilogue, scale, device):
    """The scale operand in fp32, shaped per scale_kind. A Python number
    stays one: no host-to-device copy, so the plain version can be captured
    in a CUDA graph."""
    if not torch.is_tensor(scale):
        return float(scale)
    s = scale.to(device=device, dtype=torch.float32)
    if epilogue.scale_kind == "row":
        return s.reshape(-1, 1)
    if epilogue.scale_kind == "col":
        return s.reshape(1, -1)
    return s.reshape(())


def gemm_fused_bwd_ref(a, b, g, *, epilogue: Epilogue = EPILOGUE_NONE,
                       prologue: Prologue = PROLOGUE_NONE, b2=None,
                       bias=None, residual=None, scale=None, sin=None,
                       cos=None, gamma=None, beta=None, mean=None, rstd=None,
                       preact=None, preact2=None, out=None):
    """Hand-written chain-transpose oracle of the fused backward, on full
    arrays:

        gbar[, gbar2] = epilogue.transpose_tile(g)   # the forward epilogue,
                                                     # as a prologue on g
        dAn = gbar @ Bᵀ [+ gbar2 @ B2ᵀ]              # the dA GEMM
        dA, dgamma, ... = prologue.transpose(dAn, A) # the norm transpose
        dB[, dB2] = Anᵀ @ gbar[, gbar2]              # the dB GEMM(s)
        dbias, dresidual, dscale, dsin, dcos         # epilogue.operand_grads

    ``preact``/``preact2`` are the forward's saved raw accumulators; when
    omitted they are recomputed. ``out`` (the forward output) is read only
    by the rope-table cotangents when there is no preact. Returns ``(da,
    db, grads)`` with ``grads`` keyed by operand name. Every contraction is
    in fp32, as in the reference's oracle."""
    f32 = torch.float32
    a_f32 = a.to(f32)
    an = a_f32
    pkw = {}
    if not prologue.is_identity:
        pkw = _prologue_kwargs(prologue, gamma, beta, mean, rstd)
        an = prologue.apply(a_f32, **pkw).to(a.dtype)
    an_f32 = an.to(f32)
    b_f32 = b.to(f32)
    if preact is None and (epilogue.needs_saved_preact or
                           (epilogue.rope and out is None)):
        preact = an_f32 @ b_f32
        if epilogue.gate:
            preact2 = an_f32 @ b2.to(f32)
    ekw = {}
    if epilogue.bias:
        ekw["bias"] = bias.to(f32).reshape(1, -1)
    if epilogue.scale:
        ekw["scale"] = _scale_f32(epilogue, scale, a.device)
    if epilogue.rope:
        ekw["sin"] = sin.to(f32)
        ekw["cos"] = cos.to(f32)
    g_f32 = g.to(f32)
    p32 = None if preact is None else preact.to(f32)
    p32_2 = None if preact2 is None else preact2.to(f32)
    streams = epilogue.transpose_tile(g_f32, p32, p32_2, **ekw)
    dan = streams["g_acc"] @ b_f32.T
    if epilogue.gate:
        dan = dan + streams["g_acc2"] @ b2.to(f32).T
    tr = prologue.transpose(dan, a_f32, **pkw)
    da = tr["da"].to(a.dtype)
    db = (an_f32.T @ streams["g_acc"]).to(b.dtype)
    grads = {}
    if epilogue.gate:
        grads["b2"] = (an_f32.T @ streams["g_acc2"]).to(b2.dtype)
    og = epilogue.operand_grads(
        g_f32, p32, p32_2, None if out is None else out.to(f32), **ekw)
    for name in ("bias", "scale", "sin", "cos"):
        if name in og:
            grads[name] = og[name]
    if epilogue.residual:
        grads["residual"] = g.to(residual.dtype)
    for name in prologue.operand_names():
        grads[name] = tr["d" + name]
    return da, db, grads
